"""SwinIR's frozen operation count: the matmul and conv FLOPs of one
plain forward, written down once from the model's equations
(arXiv:2108.10257, the ``nearest+conv`` real-world x4 model) and kept
here, so that the yardstick does not move when the program changes."""

from __future__ import annotations


def padded(size: int, window: int) -> int:
    return size + (-size) % window


def swinir_flops_per_frame(config: dict, height: int, width: int) -> int:
    """Matmul-equivalent FLOPs (2 x MACs) of one plain forward on one
    (H, W) input frame at its padded size: per token of each Swin block
    the qkv, proj and MLP linears and the two attention products
    (``q k^T`` and ``@ v``, each N x C MACs for windows of N tokens), the
    RSTB convs, ``conv_first``, ``conv_after_body`` and the tail's convs
    at 1x, 2x and 4x.  LayerNorm, softmax, GELU, the bias, the masks and
    the colorspace are left out."""
    window = config["window_size"]
    pixels = padded(height, window) * padded(width, window)
    c, f, ch = config["embed_dim"], config["num_feat"], config["in_chans"]
    hidden = int(c * config["mlp_ratio"])
    tokens = window * window
    block = 4 * c * c + 2 * c * hidden + 2 * tokens * c
    blocks = sum(config["depths"]) * block
    rstb_convs = len(config["depths"]) * 9 * c * c
    body = 9 * ch * c + 9 * c * c
    tail = 9 * c * f + 4 * 9 * f * f + 16 * (2 * 9 * f * f + 9 * f * ch)
    return 2 * pixels * (blocks + rstb_convs + body + tail)
