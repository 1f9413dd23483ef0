"""The whole train step's share of the card's bf16 peak: three times the
plain forward's conv FLOPs on the batch's low-res crops (forward and
backward), times the steps in the window, over the window and the
data-sheet peak."""

from portbench import yardstick

UNIT = "%"


def read(r):
    if r["traffic"]["driver"] != "train" or r["card"] is None:
        return None
    t, c = r["traffic"], r["config"]
    side = t["crop"] // c["scale"]
    flops = 3 * t["batch"] * yardstick.upscaler_flops_per_frame(c, side, side)
    peak = yardstick.card_rates(r["card"])[2] * r["chips"]
    return 100.0 * flops * r["steps"] / r["window_s"] / peak
