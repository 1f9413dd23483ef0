"""The body convs' epilogue kernel's share of its roofline: the least
time for one launch's bytes (the conv output read, the residual read and
the result written, each a bf16 feature map of the batch's frames) over
the launches' mean time in the device trace.  Nothing to read where the
program has no such kernel."""

from portbench import yardstick

UNIT = "%"


def read(r):
    timeline = r["timeline"]
    times = (timeline.kernels("conv_epilogue_residual_kernel")
             if timeline is not None else [])
    if not times or r["card"] is None or r["traffic"]["driver"] != "stream":
        return None
    t = r["traffic"]
    frames = r["batch"] // r["chips"]
    nbytes = 3 * frames * t["height"] * t["width"] * r["config"]["features"] * 2
    least = yardstick.least_seconds(nbytes, 0, yardstick.card_rates(r["card"]))
    return 100.0 * least / (sum(times) / len(times))
