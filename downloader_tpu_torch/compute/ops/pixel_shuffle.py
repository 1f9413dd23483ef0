"""Sub-pixel shuffle (depth-to-space), the u8 quantize tail, and the two
together (``pixel_shuffle_clip_u8``).

``pixel_shuffle`` keeps the reference's channel order: channel
``(di*r + dj)*C + c`` of pixel (h, w) lands at (h*r+di, w*r+dj, c).
``torch.nn.functional.pixel_shuffle`` orders channels ``c*r*r + di*r +
dj`` instead, so calling it would silently permute channels against
weights trained by the JAX package.

``quantize_u8`` is the port of the reference's one in-package Pallas
kernel (``downloader_tpu/compute/ops/pixel_shuffle.py:75-106``): on a
CUDA tensor it launches ``csrc/quantize_u8.cu``, on a CPU tensor it runs
:func:`quantize_u8_plain`.
"""

from __future__ import annotations

import torch

from .. import kernels


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, H, W, C*scale^2) -> (B, H*scale, W*scale, C)."""
    b, h, w, c_full = x.shape
    if c_full % (scale * scale) != 0:
        raise ValueError(f"channels {c_full} not divisible by scale^2 {scale * scale}")
    c = c_full // (scale * scale)
    # (B,H,W,r,r,C) -> interleave the sub-pixel grids into space
    x = x.reshape(b, h, w, scale, scale, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * scale, w * scale, c)


def pixel_shuffle_clip_u8(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Inference tail: shuffle + clip to [0, 255] + round to uint8, the
    shuffle a reshape and the quantize :func:`quantize_u8` (one launch of
    the kernel on a CUDA tensor)."""
    return quantize_u8(pixel_shuffle(x.float(), scale).contiguous())


def quantize_u8_plain(x: torch.Tensor) -> torch.Tensor:
    """clip(round(x), 0, 255) -> uint8 in plain PyTorch; ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    return torch.clamp(torch.round(x.float()), 0, 255).to(torch.uint8)


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """clip(round(x), 0, 255) -> uint8, any shape, f32 or bf16.

    A CUDA tensor launches the kernel (contiguous input required) on the
    current stream without synchronising; a CPU tensor takes
    :func:`quantize_u8_plain`.  ``quantize_u8.launches`` counts kernel
    launches."""
    if x.device.type == "cpu":
        return quantize_u8_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_u8: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_u8 kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_u8 kernel needs a contiguous input")
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return out
    launch = kernels.function("quantize_u8")
    kernels.check(launch(x.data_ptr(), out.data_ptr(), x.numel(),
                         int(x.dtype == torch.bfloat16),
                         kernels.stream_handle(x.device)), "quantize_u8")
    quantize_u8.launches += 1
    return out


quantize_u8.launches = 0
