"""YCbCr <-> RGB conversion, chroma resampling and the fused sub-pixel
output tails, on (B, H, W) planes in the 0..255 float domain.

Coefficients are BT.601 full-range (the JPEG/Y4M ``C420jpeg``
convention), the reference's numpy float32 arrays and products computed
by the very same expressions (``downloader_tpu/compute/ops/colorspace.py``
:32-49, :73-76, and ``255.0 * _RGB2YCC[i]`` in the tails), so both
packages start from identical f32 constants.

Numerics against the reference on XLA's CPU lowering:

- the tails' 3-wide contractions are ``fma(x2, w2, fma(x1, w1, x0*w0))``
  and the sub-pixel mean sums left to right, so the plain tails here
  emulate exactly that (:func:`_fma`) and match the JAX tails byte for
  byte; the CUDA kernel (``csrc/s2d_tail.cu``) does the same with
  ``__fmaf_rn``;
- the sub-pixel mean is that left-to-right sum times ``f32(1/n)``, as
  XLA's CPU lowering of ``mean(dtype=f32)`` computes it (at scale 3 a
  division would differ in the last bit);
- ``ycbcr_to_unit_rgb``/``rgb_to_ycbcr`` are plain f32 sums of products;
  XLA's CPU dot rounds some output channels as an fma chain instead, so
  those differ from the reference by a few ulp (bounds stated in the
  tests) — the model casts its input to bf16 right after, which absorbs
  nearly all of it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import kernels
from .pixel_shuffle import quantize_u8, quantize_u8_plain

# forward (RGB -> YCbCr) matrix, rows = (Y, Cb, Cr)
_RGB2YCC = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    dtype=np.float32,
)

# inverse (YCbCr -> RGB) matrix, rows = (R, G, B), applied to (Y, Cb-128, Cr-128)
_YCC2RGB = np.array(
    [
        [1.0, 0.0, 1.402],
        [1.0, -0.344136, -0.714136],
        [1.0, 1.772, 0.0],
    ],
    dtype=np.float32,
)

# the model-domain input transform: /255 and the +-128 chroma offsets
# folded into the matrix and a bias vector
_YCC2RGB_UNIT = (_YCC2RGB / 255.0).astype(np.float32)
_YCC2RGB_UNIT_BIAS = (
    -(128.0 / 255.0) * (_YCC2RGB[:, 1] + _YCC2RGB[:, 2])
).astype(np.float32)

# the tails' display-scaled rows, as the reference writes them inline
_Y_ROW = 255.0 * _RGB2YCC[0]
_CB_ROW = 255.0 * _RGB2YCC[1]
_CR_ROW = 255.0 * _RGB2YCC[2]


def _rows(m: np.ndarray, i: int):
    return [float(v) for v in m[i]]


def _plain_contract(planes, weights):
    """f32 sum of products, left to right: ((p0*w0 + p1*w1) + p2*w2)."""
    out = None
    for plane, w in zip(planes, weights):
        term = plane * w
        out = term if out is None else out + term
    return out


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor,
                 cr: torch.Tensor) -> torch.Tensor:
    """Full-res (B, H, W) f32 planes in 0..255 -> (B, H, W, 3) RGB in
    0..255: the inverse matrix on (Y, Cb-128, Cr-128)."""
    ycc = (y, cb - 128.0, cr - 128.0)
    return torch.stack(
        [_plain_contract(ycc, _rows(_YCC2RGB, j)) for j in range(3)], dim=-1)


def ycbcr_to_unit_rgb(y: torch.Tensor, cb: torch.Tensor,
                      cr: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 YCbCr planes in 0..255 -> (B, H, W, 3) RGB in
    [0, 1] (the model's input domain)."""
    return torch.stack(
        [_plain_contract((y, cb, cr), _rows(_YCC2RGB_UNIT, j))
         + float(_YCC2RGB_UNIT_BIAS[j]) for j in range(3)], dim=-1)


def rgb_to_ycbcr(rgb: torch.Tensor):
    """(B, H, W, 3) RGB 0..255 -> three (B, H, W) float planes in 0..255."""
    chans = rgb.unbind(-1)
    y = _plain_contract(chans, _rows(_RGB2YCC, 0))
    cb = _plain_contract(chans, _rows(_RGB2YCC, 1)) + 128.0
    cr = _plain_contract(chans, _rows(_RGB2YCC, 2)) + 128.0
    return y, cb, cr


def upsample_chroma(plane: torch.Tensor, sub_h: int, sub_w: int) -> torch.Tensor:
    """(B, H/sub_h, W/sub_w) -> (B, H, W) by nearest-neighbour repeat."""
    if sub_h > 1:
        plane = plane.repeat_interleave(sub_h, dim=1)
    if sub_w > 1:
        plane = plane.repeat_interleave(sub_w, dim=2)
    return plane


def downsample_chroma(plane: torch.Tensor, sub_h: int, sub_w: int) -> torch.Tensor:
    """(B, H, W) -> (B, H/sub_h, W/sub_w) by box (mean) filter, summed
    over the window in row-major order as XLA's CPU reduce does."""
    if sub_h == 1 and sub_w == 1:
        return plane
    b, h, w = plane.shape
    plane = plane.reshape(b, h // sub_h, sub_h, w // sub_w, sub_w)
    total = plane[:, :, 0, :, 0]
    for i in range(sub_h):
        for j in range(sub_w):
            if i or j:
                total = total + plane[:, :, i, :, j]
    return total / (sub_h * sub_w)


# -- the fused sub-pixel tails -------------------------------------------

def _fma(a: torch.Tensor, w: float, c: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(a, w, c)`` with ONE rounding, for f32 tensors.

    In float64 the product is exact (24 + 24 bits); TwoSum recovers the
    float64 sum's rounding error exactly, and nudging an inexact sum to
    the neighbour with an odd last bit (round-to-odd) makes the final
    cast to float32 a single correct rounding, since 53 >= 24 + 2 bits.
    """
    p = a.double() * w
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, math.inf), err)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _contract3(sub: torch.Tensor, row: np.ndarray) -> torch.Tensor:
    """(..., 3) f32 -> (...): ``fma(x2, w2, fma(x1, w1, x0*w0))``, the
    order of the reference's ``jnp.matmul(x, w, precision="highest")``
    on XLA's CPU lowering."""
    w0, w1, w2 = (float(v) for v in row)
    x0, x1, x2 = sub.unbind(-1)
    acc = (x0.double() * w0).float()  # exact product, one rounding
    return _fma(x2, w2, _fma(x1, w1, acc))


def _inv_count(n: int) -> np.float32:
    """``f32(1/n)``: the factor XLA's CPU lowering of ``mean(dtype=f32)``
    multiplies the sum by (it does not divide), and the s2d tail kernel's."""
    return np.float32(1.0 / n)


def _mean_subpixels(sub: torch.Tensor, axis: int) -> torch.Tensor:
    """f32 mean over ``axis`` as XLA's CPU lowering computes it: the sum
    taken left to right, then times ``f32(1/n)``.  At scales 1, 2 and 4
    that equals a division; at scale 3 ``x * f32(1/9)`` and ``x / 9``
    differ in the last bit on about a tenth of the values."""
    parts = sub.unbind(axis)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total * torch.tensor(_inv_count(len(parts)))


def fused_subpixel_ycc(subpixel_rgb: torch.Tensor, scale: int):
    """Sub-pixel-domain output tail on the plain head's (B, H, W,
    scale^2*3) RGB maps in the model's [0, 1] domain: colorspace +
    quantize before the pixel shuffle.  Returns ``(y_u8, cb_u8,
    cr_u8)``, luma at (B, H*scale, W*scale) and chroma at (B, H, W);
    the same numbers as the reference's ``fused_subpixel_ycc``."""
    b, h, w, c_full = subpixel_rgb.shape
    r = scale
    if c_full != r * r * 3:
        raise ValueError(f"expected {r * r * 3} sub-pixel channels, got {c_full}")
    # channel index factorizes as (di, dj, rgb) — matching pixel_shuffle
    sub = subpixel_rgb.float().reshape(b, h, w, r * r, 3)
    y_u8 = quantize_u8(_contract3(sub, _Y_ROW).contiguous())
    y_full = (y_u8.reshape(b, h, w, r, r).permute(0, 1, 3, 2, 4)
              .reshape(b, h * r, w * r))
    mean_rgb = _mean_subpixels(sub, 3)
    cb = _contract3(mean_rgb, _CB_ROW) + 128.0
    cr = _contract3(mean_rgb, _CR_ROW) + 128.0
    return y_full, quantize_u8(cb.contiguous()), quantize_u8(cr.contiguous())


def fused_subpixel_ycc_s2d_plain(packed: torch.Tensor, scale: int):
    """Plain PyTorch version of :func:`fused_subpixel_ycc_s2d`, in the
    kernel's arithmetic order (see the module docstring)."""
    b, hh, ww, c_full = packed.shape
    r = scale
    if c_full != 4 * r * r * 3:
        raise ValueError(
            f"expected {4 * r * r * 3} packed sub-pixel channels, got {c_full}")
    sub = packed.float().reshape(b, hh, ww, 4, r * r, 3)
    y_u8 = quantize_u8_plain(_contract3(sub, _Y_ROW))  # (b, hh, ww, 4, r*r)
    y_full = (y_u8.reshape(b, hh, ww, 2, 2, r, r)       # (di, dj, si, sj)
              .permute(0, 1, 3, 5, 2, 4, 6)             # rows i,di,si / cols j,dj,sj
              .reshape(b, hh * 2 * r, ww * 2 * r))
    mean_rgb = _mean_subpixels(sub, 4)                  # (b, hh, ww, 4, 3)

    def _chroma(row):
        plane = quantize_u8_plain(_contract3(mean_rgb, row) + 128.0)
        return (plane.reshape(b, hh, ww, 2, 2).permute(0, 1, 3, 2, 4)
                .reshape(b, hh * 2, ww * 2))

    return y_full, _chroma(_CB_ROW), _chroma(_CR_ROW)


def _tail_coeffs() -> kernels.TailCoeffs:
    coeffs = kernels.TailCoeffs()
    for field, row in (("y", _Y_ROW), ("cb", _CB_ROW), ("cr", _CR_ROW)):
        getattr(coeffs, field)[:] = [float(v) for v in row]
    return coeffs


def fused_subpixel_ycc_s2d(packed: torch.Tensor, scale: int):
    """The fused sub-pixel tail for the s2d head's packed output.

    Input: ``(B, H/2, W/2, 4*scale^2*3)``; channel block ``g = di*2+dj``
    holds the sub-pixel maps of full-res position ``(2i+di, 2j+dj)``.
    Output: u8 ``y`` at (B, H*scale, W*scale) and ``cb``, ``cr`` at (B, H,
    W) — byte-identical to the reference's ``fused_subpixel_ycc_s2d``.

    A CUDA tensor (bf16, contiguous, any ``scale >= 1``) launches
    ``csrc/s2d_tail.cu``: one thread per full-res position does the
    contractions, the sub-pixel mean, all three quantizes and both
    shuffles, with no f32 intermediate in memory.  Its bound is the bytes
    (read 6*scale^2 and write scale^2 + 2 per full-res position; 0.149 ms
    at scale 2 on the 1080p main path's (8, 540, 960, 48) on an H100 SXM,
    PERF.md).  ``fused_subpixel_ycc_s2d.launches`` counts its launches.
    A CPU tensor takes :func:`fused_subpixel_ycc_s2d_plain`."""
    if packed.device.type == "cpu":
        return fused_subpixel_ycc_s2d_plain(packed, scale)
    if packed.device.type != "cuda":
        raise ValueError(f"fused_subpixel_ycc_s2d: unsupported device {packed.device}")
    r = int(scale)
    if r < 1 or packed.ndim != 4 or packed.shape[-1] != 12 * r * r:
        raise ValueError(
            f"s2d tail kernel takes (B, H/2, W/2, 12*scale^2) at a scale >= 1, "
            f"got {tuple(packed.shape)} at scale {scale}")
    if packed.dtype != torch.bfloat16:
        raise TypeError(f"s2d tail kernel takes bfloat16, got {packed.dtype}")
    # its widest load: a 6*r^2-byte block at a multiple of 6*r^2 (scales
    # above 4 load one value at a time)
    align = math.gcd(6 * r * r, 16) if r <= 4 else 2
    if not packed.is_contiguous() or packed.data_ptr() % align:
        raise ValueError(f"s2d tail kernel needs a contiguous, {align}-byte "
                         "aligned input")
    if packed.shape[0] > 65535:
        raise ValueError(f"s2d tail kernel takes at most 65535 frames, "
                         f"got {packed.shape[0]}")
    out = launch_s2d_tail(packed, r, kernels.function("s2d_tail"))
    if out[0].numel():
        kernels.count_launch(fused_subpixel_ycc_s2d)
    return out


def launch_s2d_tail(packed: torch.Tensor, r: int, launch):
    """Allocate the tail's outputs and run ``launch``, a build of
    ``csrc/s2d_tail.cu``, on a ``packed`` that
    :func:`fused_subpixel_ycc_s2d` has checked.  Counts nothing: the
    wrapper counts its own launches, and a timing run of another build
    (``chip_smoke.py``) is no launch of the port's."""
    b, hh, ww, _ = packed.shape
    height, width = 2 * hh, 2 * ww
    luma = torch.empty((b, height * r, width * r), dtype=torch.uint8,
                       device=packed.device)
    chroma = torch.empty((2, b, height, width), dtype=torch.uint8,
                         device=packed.device)
    if luma.numel():
        kernels.launch(launch, "s2d_tail", packed.device, packed.data_ptr(),
                       luma.data_ptr(), chroma.data_ptr(), b, height, width, r,
                       float(_inv_count(r * r)), _tail_coeffs())
    return luma, chroma[0], chroma[1]


fused_subpixel_ycc_s2d.launches = 0
