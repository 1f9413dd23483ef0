"""The standalone quantize kernel's share of its roofline on the generic
tail, where each batch quantizes the f32 luma at the output size and the
two chroma planes at half of it: the least time for a batch's bytes
(f32 read once, u8 written once) over the time of its three launches in
the device trace."""

from portbench import yardstick

UNIT = "%"


def read(r):
    timeline = r["timeline"]
    times = timeline.kernels("quantize_f32") if timeline is not None else []
    if not times or r["card"] is None or r["traffic"]["driver"] != "stream":
        return None
    t, scale = r["traffic"], r["config"]["scale"]
    frames = r["batch"] // r["chips"]
    luma = frames * t["height"] * scale * t["width"] * scale
    least = yardstick.least_seconds(yardstick.quantize_bytes(luma * 3 // 2), 0,
                                    yardstick.card_rates(r["card"]))
    return 100.0 * least / (3 * sum(times) / len(times))
