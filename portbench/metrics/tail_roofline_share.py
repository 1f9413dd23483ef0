"""The s2d tail kernel's share of its roofline: the least time for its
bytes (the head's packed bf16 maps read once, the u8 planes written
once) over its mean time in the device trace."""

from portbench import yardstick

UNIT = "%"


def read(r):
    timeline = r["timeline"]
    times = timeline.kernels("s2d_tail_kernel") if timeline is not None else []
    if not times or r["card"] is None:
        return None
    t = r["traffic"]
    frames = r["batch"] // r["chips"]
    nbytes = yardstick.s2d_tail_bytes(frames, t["height"], t["width"], r["config"]["scale"])
    least = yardstick.least_seconds(nbytes, 0, yardstick.card_rates(r["card"]))
    return 100.0 * least / (sum(times) / len(times))
