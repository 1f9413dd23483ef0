"""SwinIR's plain float32 forward and its Y4M output path.

The model (arXiv:2108.10257; the published real-world x4 model,
``models/network_swinir.py`` of github.com/JingyunLiang/SwinIR with
``upsampler='nearest+conv'``, ``resi_connection='1conv'``), written from
its equations:

- pad H and W up to multiples of the window (reflect, bottom and right),
  ``x = (x - mean) * img_range``, ``conv_first`` (3x3);
- tokens, ``patch_embed.norm``, the RSTBs, ``norm``, back to a map, and
  ``conv_after_body(features) + conv_first's output``;
- an RSTB: its Swin blocks, a 3x3 conv, plus the RSTB's input;
- a Swin block: ``x + proj(attn(norm1(x)))`` in windows (odd blocks roll
  the map by half a window first and back after, and add the shift mask
  of the nine regions, -100 between regions), then ``x +
  fc2(gelu(fc1(norm2(x))))``; the attention adds the learned
  relative-position bias to ``q k^T`` (q scaled by head_dim ** -0.5);
- the tail: conv + LeakyReLU(0.01), two rounds of nearest x2 and conv +
  LeakyReLU(0.2), ``conv_hr`` + LeakyReLU(0.2), ``conv_last``, then
  ``x / img_range + mean``, cropped to (4H, 4W).

Weights are a dict under the official parameter names.  The attention is
written out (``q @ k^T``, softmax, ``@ v``), tokens are (B, L, C) as in
the official code, and each frame runs alone.

``precision="fp8"`` is the control: every matmul's and conv's operands
and output are rounded to float8 e4m3 with one scale per tensor (as
:mod:`portbench.reference.upscaler` does); ``None`` is float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.upscaler import round_fp8, to_planes, unit_rgb


def _fp8(x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    return round_fp8(x) if precision == "fp8" else x


def _matmul(a, b, precision):
    return _fp8(_fp8(a, precision) @ _fp8(b, precision), precision)


def _linear(x, weights, name, precision):
    w, b = weights[f"{name}.weight"].float(), weights[f"{name}.bias"].float()
    return _matmul(x, w.t(), precision) + b


def _conv(x, weights, name, precision):
    w, b = weights[f"{name}.weight"].float(), weights[f"{name}.bias"].float()
    y = F.conv2d(_fp8(x, precision), _fp8(w, precision), None, padding=1)
    return _fp8(y, precision) + b[:, None, None]


def _norm(x, weights, name):
    return F.layer_norm(x, (x.shape[-1],), weights[f"{name}.weight"].float(),
                        weights[f"{name}.bias"].float(), 1e-5)


def _partition(x, window):
    """(B, H, W, C) -> (B * nW, window * window, C)."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _reverse(windows, window, h, w):
    c = windows.shape[-1]
    x = windows.view(-1, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def relative_index(window: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).clone()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def region_mask(h: int, w: int, window: int, shift: int) -> torch.Tensor:
    """(nW, N, N): 0 within one of the nine regions, -100 between."""
    img = torch.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    ids = _partition(img, window).view(-1, window * window)
    mask = ids.unsqueeze(1) - ids.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def _attention(x, weights, prefix, heads, window, mask, precision):
    count, n, c = x.shape
    qkv = _linear(x, weights, f"{prefix}.qkv", precision)
    qkv = qkv.reshape(count, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * (c // heads) ** -0.5, qkv[1], qkv[2]
    attn = _matmul(q, k.transpose(-2, -1), precision)
    table = weights[f"{prefix}.relative_position_bias_table"].float()
    index = relative_index(window).to(table.device).view(-1)
    attn = attn + table[index].view(n, n, -1).permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(count // nw, nw, heads, n, n) + mask[None, :, None]
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    out = _matmul(attn, v, precision).transpose(1, 2).reshape(count, n, c)
    return _linear(out, weights, f"{prefix}.proj", precision)


def _block(x, size, weights, prefix, heads, window, shift, mask, precision):
    h, w = size
    b, _, c = x.shape
    y = _norm(x, weights, f"{prefix}.norm1").view(b, h, w, c)
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    y = _attention(_partition(y, window), weights, f"{prefix}.attn", heads, window,
                   mask if shift else None, precision)
    y = _reverse(y, window, h, w)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    x = x + y.reshape(b, h * w, c)
    y = _linear(_norm(x, weights, f"{prefix}.norm2"), weights, f"{prefix}.mlp.fc1",
                precision)
    return x + _linear(F.gelu(y), weights, f"{prefix}.mlp.fc2", precision)


def _tokens(x):
    return x.flatten(2).transpose(1, 2)


def _map(x, size):
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], *size)


def forward(weights: Dict[str, torch.Tensor], rgb: torch.Tensor, config: dict,
            precision: Optional[str] = None) -> torch.Tensor:
    """(n, 3, H, W) RGB in [0, 1] -> (n, 3, 4H, 4W) RGB."""
    window, scale = config["window_size"], config["scale"]
    height, width = rgb.shape[2:]
    x = F.pad(rgb, (0, (window - width % window) % window,
                    0, (window - height % window) % window), mode="reflect")
    size = tuple(x.shape[2:])
    mean = torch.tensor(config["rgb_mean"], device=x.device).view(1, 3, 1, 1)
    x = (x - mean) * config["img_range"]
    first = _conv(x, weights, "conv_first", precision)
    shift = window // 2
    mask = region_mask(*size, window, shift).to(x.device)
    t = _norm(_tokens(first), weights, "patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(config["depths"], config["num_heads"])):
        start = t
        for j in range(depth):
            t = _block(t, size, weights, f"layers.{i}.residual_group.blocks.{j}", heads,
                       window, 0 if j % 2 == 0 else shift, mask, precision)
        t = _tokens(_conv(_map(t, size), weights, f"layers.{i}.conv", precision)) + start
    t = _norm(t, weights, "norm")
    x = _conv(_map(t, size), weights, "conv_after_body", precision) + first
    x = F.leaky_relu(_conv(x, weights, "conv_before_upsample.0", precision), 0.01)
    for name in ("conv_up1", "conv_up2"):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = F.leaky_relu(_conv(x, weights, name, precision), 0.2)
    x = F.leaky_relu(_conv(x, weights, "conv_hr", precision), 0.2)
    x = _conv(x, weights, "conv_last", precision)
    x = x / config["img_range"] + mean
    return x[:, :, :height * scale, :width * scale]


def upscale(weights: Dict[str, torch.Tensor], y: torch.Tensor, cb: torch.Tensor,
            cr: torch.Tensor, config: dict, precision: Optional[str] = None):
    """u8 planes of n frames -> the upscaled u8 planes, chroma kept at the
    input's subsampling, one frame at a time.  TF32 stays off inside, so
    float32 is float32."""
    sub_h, sub_w = y.shape[1] // cb.shape[1], y.shape[2] // cb.shape[2]
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            planes = [to_planes(forward(weights, unit_rgb(y[i:i + 1], cb[i:i + 1],
                                                          cr[i:i + 1]),
                                        config, precision), sub_h, sub_w)
                      for i in range(y.shape[0])]
        return tuple(torch.cat(p) for p in zip(*planes))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
