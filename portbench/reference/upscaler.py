"""The upscaler's plain float32 forward and its Y4M output path.

The model (ESPCN-style, arXiv:1609.05158, in the geometry the port
ships): a 5x5 stem conv to ``features`` channels and a relu, ``depth - 1``
residual 3x3 convs (``x = relu(conv(x)) + x``), a 3x3 head to
``3 * scale**2`` sub-pixel channels and a pixel shuffle.  Inputs are
planar 4:2:0-style u8 YCbCr (BT.601 full range): chroma is repeated to
full size, converted to RGB in [0, 1], upscaled, converted back to
YCbCr in 0..255, its chroma box-averaged to the output's subsampling,
rounded half to even and clipped to u8.

Weights are a dict of OIHW kernels and biases under the names
``stem``, ``body_<i>``, ``subpixel`` (``<name>.weight``,
``<name>.bias``), as the benchmark makes them.

``precision="fp8"`` is the control: every conv's input, kernel and
output is rounded to float8 e4m3 with one scale per tensor (the format
a lower-precision serving path would take); ``None`` is float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

RGB2YCC = ((0.299, 0.587, 0.114),
           (-0.168736, -0.331264, 0.5),
           (0.5, -0.418688, -0.081312))
YCC2RGB = ((1.0, 0.0, 1.402),
           (1.0, -0.344136, -0.714136),
           (1.0, 1.772, 0.0))
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def conv_names(depth: int) -> List[Tuple[str, int]]:
    """(name, kernel size) of every conv, input to output."""
    return ([("stem", 5)] + [(f"body_{i}", 3) for i in range(depth - 1)]
            + [("subpixel", 3)])


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor."""
    amax = x.abs().max().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _conv(x, weights, name, size, precision):
    w, b = weights[f"{name}.weight"].float(), weights[f"{name}.bias"].float()
    if precision == "fp8":
        x, w = round_fp8(x), round_fp8(w)
    y = F.conv2d(x, w, None, padding=size // 2)
    if precision == "fp8":
        y = round_fp8(y)
    return y + b[:, None, None]


def forward(weights: Dict[str, torch.Tensor], rgb: torch.Tensor, scale: int,
            depth: int, precision: Optional[str] = None) -> torch.Tensor:
    """(n, 3, H, W) RGB in [0, 1] -> (n, 3, H*scale, W*scale) RGB."""
    names = conv_names(depth)
    x = F.relu(_conv(rgb, weights, *names[0], precision))
    for name, size in names[1:-1]:
        x = F.relu(_conv(x, weights, name, size, precision)) + x
    return pixel_shuffle(_conv(x, weights, *names[-1], precision), scale)


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(n, 3*r*r, H, W) -> (n, 3, H*r, W*r), the model's channel order:
    channel ``(di*r + dj)*3 + c`` lands at (h*r + di, w*r + dj) of colour
    ``c`` (``F.pixel_shuffle`` orders them ``c*r*r + di*r + dj``)."""
    n, _, h, w = x.shape
    x = x.reshape(n, scale, scale, 3, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, 3, h * scale, w * scale)


def _mix(planes, rows, offsets=(0.0, 0.0, 0.0)):
    return [sum(planes[k] * rows[j][k] for k in range(3)) + offsets[j]
            for j in range(3)]


def unit_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """u8 planes (n, H, W), (n, H/s, W/s), (n, H/s, W/s) -> (n, 3, H, W)
    RGB in [0, 1]; chroma repeated to full size (nearest)."""
    sub_h, sub_w = y.shape[1] // cb.shape[1], y.shape[2] // cb.shape[2]

    def full(p):
        return p.float().repeat_interleave(sub_h, 1).repeat_interleave(sub_w, 2)

    ycc = [y.float(), full(cb) - 128.0, full(cr) - 128.0]
    return torch.stack(_mix(ycc, YCC2RGB), dim=1) / 255.0


def to_planes(rgb: torch.Tensor, sub_h: int, sub_w: int):
    """(n, 3, H, W) RGB in [0, 1] -> u8 Y (n, H, W) and Cb, Cr box-averaged
    to (n, H/sub_h, W/sub_w)."""
    y, cb, cr = _mix(list((rgb * 255.0).unbind(1)), RGB2YCC, (0.0, 128.0, 128.0))

    def box(p):
        n, h, w = p.shape
        return p.reshape(n, h // sub_h, sub_h, w // sub_w, sub_w).mean(dim=(2, 4))

    return tuple(torch.round(p).clamp(0, 255).to(torch.uint8)
                 for p in (y, box(cb), box(cr)))


def upscale(weights: Dict[str, torch.Tensor], y: torch.Tensor, cb: torch.Tensor,
            cr: torch.Tensor, scale: int, depth: int,
            precision: Optional[str] = None):
    """u8 planes of n frames -> the upscaled u8 planes, chroma kept at the
    input's subsampling.  TF32 stays off inside, so float32 is float32."""
    sub_h, sub_w = y.shape[1] // cb.shape[1], y.shape[2] // cb.shape[2]
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            out = forward(weights, unit_rgb(y, cb, cr), scale, depth, precision)
            return to_planes(out, sub_h, sub_w)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
