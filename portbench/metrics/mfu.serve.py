"""The whole engine step's share of the cards' bf16 peak: the plain
model's conv FLOPs per frame (the plain 3x3 head, whatever head runs)
times the frames written in the window, over the window and the cards'
data-sheet peak."""

from portbench import yardstick

UNIT = "%"


def read(r):
    if r["traffic"]["driver"] != "stream" or r["card"] is None:
        return None
    t = r["traffic"]
    flops = yardstick.upscaler_flops_per_frame(r["config"], t["height"], t["width"])
    peak = yardstick.card_rates(r["card"])[2] * r["chips"]
    return 100.0 * flops * r["frames"] / r["window_s"] / peak
