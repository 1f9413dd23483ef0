"""The plain float32 SwinIR forward the port's tests hold it to: the
same equations as the benchmark's reference (``portbench/reference/
swinir.py``, which a test holds this copy to), written out in plain
``torch`` with no kernel, cache or batching of the port.

``leave_out`` drops a part of the model (``"shift_mask"``, ``"bias"``:
the shifted blocks' region mask, the relative-position bias), so that a
test can show its tolerance is tight enough to see the part missing.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.nn.functional as F


def _linear(x, weights, name):
    w, b = weights[f"{name}.weight"].float(), weights[f"{name}.bias"].float()
    return x @ w.t() + b


def _conv(x, weights, name):
    w, b = weights[f"{name}.weight"].float(), weights[f"{name}.bias"].float()
    return F.conv2d(x, w, None, padding=1) + b[:, None, None]


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


def _attention(x, weights, prefix, heads, window, mask, leave_out):
    count, n, c = x.shape
    qkv = _linear(x, weights, f"{prefix}.qkv")
    qkv = qkv.reshape(count, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * (c // heads) ** -0.5, qkv[1], qkv[2]
    attn = q @ k.transpose(-2, -1)
    table = weights[f"{prefix}.relative_position_bias_table"].float()
    index = relative_index(window).to(table.device).view(-1)
    if "bias" not in leave_out:
        attn = attn + table[index].view(n, n, -1).permute(2, 0, 1)[None]
    if mask is not None and "shift_mask" not in leave_out:
        nw = mask.shape[0]
        attn = attn.view(count // nw, nw, heads, n, n) + mask[None, :, None]
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(count, n, c)
    return _linear(out, weights, f"{prefix}.proj")


def _block(x, size, weights, prefix, heads, window, shift, mask,
           leave_out):
    h, w = size
    b, _, c = x.shape
    y = _norm(x, weights, f"{prefix}.norm1").view(b, h, w, c)
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    y = _attention(_partition(y, window), weights, f"{prefix}.attn", heads, window,
                   mask if shift else None, leave_out)
    y = _reverse(y, window, h, w)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    x = x + y.reshape(b, h * w, c)
    y = _linear(_norm(x, weights, f"{prefix}.norm2"), weights, f"{prefix}.mlp.fc1")
    return x + _linear(F.gelu(y), weights, f"{prefix}.mlp.fc2")


def _tokens(x):
    return x.flatten(2).transpose(1, 2)


def _map(x, size):
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], *size)


def forward(weights: Dict[str, torch.Tensor], rgb: torch.Tensor, config: dict,
            leave_out: Iterable[str] = ()) -> torch.Tensor:
    """(n, 3, H, W) RGB in [0, 1] -> (n, 3, 4H, 4W) RGB."""
    leave_out = frozenset(leave_out)
    window, scale = config["window_size"], config["scale"]
    height, width = rgb.shape[2:]
    x = F.pad(rgb, (0, (window - width % window) % window,
                    0, (window - height % window) % window), mode="reflect")
    size = tuple(x.shape[2:])
    mean = torch.tensor(config["rgb_mean"], device=x.device).view(1, 3, 1, 1)
    x = (x - mean) * config["img_range"]
    first = _conv(x, weights, "conv_first")
    shift = window // 2
    mask = region_mask(*size, window, shift).to(x.device)
    t = _norm(_tokens(first), weights, "patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(config["depths"], config["num_heads"])):
        start = t
        for j in range(depth):
            t = _block(t, size, weights, f"layers.{i}.residual_group.blocks.{j}", heads,
                       window, 0 if j % 2 == 0 else shift, mask, leave_out)
        t = _tokens(_conv(_map(t, size), weights, f"layers.{i}.conv")) + start
    t = _norm(t, weights, "norm")
    x = _conv(_map(t, size), weights, "conv_after_body") + first
    x = F.leaky_relu(_conv(x, weights, "conv_before_upsample.0"), 0.01)
    for name in ("conv_up1", "conv_up2"):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = F.leaky_relu(_conv(x, weights, name), 0.2)
    x = F.leaky_relu(_conv(x, weights, "conv_hr"), 0.2)
    x = _conv(x, weights, "conv_last")
    x = x / config["img_range"] + mean
    return x[:, :, :height * scale, :width * scale]
