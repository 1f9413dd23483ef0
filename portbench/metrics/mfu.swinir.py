"""The whole engine step's share of the cards' bf16 peak on a SwinIR
cell: the plain model's matmul and conv FLOPs per frame at the padded
size (``portbench/swinir_flops.py``) times the frames counted in the
window, over the window and the cards' data-sheet peak."""

from portbench import yardstick
from portbench.swinir_flops import swinir_flops_per_frame

UNIT = "%"


def read(r):
    if (r["traffic"]["driver"] != "stream_arch" or r["config"].get("arch") != "swinir"
            or r["card"] is None):
        return None
    t = r["traffic"]
    flops = swinir_flops_per_frame(r["config"], t["height"], t["width"])
    peak = yardstick.card_rates(r["card"])[2] * r["chips"]
    return 100.0 * flops * r["frames"] / r["window_s"] / peak
