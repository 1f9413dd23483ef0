"""Space-to-depth head: the model's 3x3 sub-pixel projection as one
stride-2 4x4 conv with 4x the output channels.

A SAME 3x3 conv evaluated at the four positions of a 2x2 output block
reads a shared 4x4 input window.  Packing the four shifted 3x3 kernels
into one stride-2 4x4 conv computes exactly the same numbers —

    out3x3[b, 2i+di, 2j+dj, c] == out4x4[b, i, j, (di*2+dj)*C + c]

— with N = 4*C output channels (48 at scale 2).  The packed kernel is
built from the model's ordinary ``subpixel`` params, so checkpoints keep
the plain 3x3 head.  The conv itself runs on cuDNN, as the reference
left it to XLA's conv; the hand-written Hopper kernel for this head is a
later piece of the port.

Requires even H and W.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pack_s2d_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, C) HWIO SAME-conv kernel -> (4, 4, Cin, 4*C) stride-2
    packed kernel.  Output channel block g = di*2+dj holds the kernel
    shifted to sub-position (di, dj) — padded (di, 1-di) rows and
    (dj, 1-dj) columns; blocks never overlap, zeros fill the taps
    outside each 3x3 sub-window."""
    kh, kw = kernel.shape[:2]
    if (kh, kw) != (3, 3):
        raise ValueError(f"s2d packing expects a 3x3 kernel, got {kh}x{kw}")
    # F.pad lists (last dim, ..., first dim): O, I, W, H
    blocks = [
        F.pad(kernel, (0, 0, 0, 0, dj, 1 - dj, di, 1 - di))
        for di in (0, 1) for dj in (0, 1)
    ]
    return torch.cat(blocks, dim=-1)


def s2d_head(feats: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Apply the packed head: (B, H, W, Cin) NHWC -> (B, H/2, W/2, 4*C).

    ``kernel``/``bias`` are the plain ``subpixel`` head's (3, 3, Cin, C)
    HWIO kernel and (C,) bias; H and W must be even.  The bias is added
    after the conv, in the compute dtype (tiled in block order g), as
    the reference does — never inside ``conv2d``."""
    b, h, w, _ = feats.shape
    if h % 2 or w % 2:
        raise ValueError(f"s2d head needs even dims, got {h}x{w}")
    k4 = pack_s2d_kernel(kernel).to(compute_dtype).permute(3, 2, 0, 1)
    # the NHWC tensor viewed as NCHW is channels_last: zero-copy
    x = feats.to(compute_dtype).permute(0, 3, 1, 2)
    out = F.conv2d(x, k4.contiguous(memory_format=torch.channels_last),
                   None, stride=2, padding=1)
    # cuDNN keeps the channels_last layout, so the NHWC result is already
    # contiguous and .contiguous() is a no-op that only guards the tail
    return (out.permute(0, 2, 3, 1)
            + bias.repeat(4).to(compute_dtype)).contiguous()
