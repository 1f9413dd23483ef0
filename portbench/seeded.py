"""Inputs and weights made from the run's seed, on the device, in a few
large calls: the same seed gives the same numbers on the same device."""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.upscaler import conv_names

# lecun-normal's std correction for a normal cut at two deviations
_TRUNC = 0.87962566103423978


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % 2**63)


def weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 OIHW kernels (lecun-normal, cut at two deviations) and
    biases for every conv of ``config``.  The head's kernel is scaled by
    ``head_gain`` and its bias centred on ``head_bias`` so that outputs
    fall mostly inside the u8 range, as a trained model's do."""
    f, c, r = config["features"], config["channels"], config["scale"]
    shapes = {"stem": (f, c, 5, 5), "subpixel": (c * r * r, f, 3, 3)}
    shapes.update({f"body_{i}": (f, f, 3, 3) for i in range(config["depth"] - 1)})
    names = [name for name, _ in conv_names(config["depth"])]
    g = generator(seed, device)
    sizes = [math.prod(shapes[n]) for n in names]
    kernels = torch.randn(sum(sizes), generator=g, device=device).clamp_(-2.0, 2.0)
    outs = [shapes[n][0] for n in names]
    biases = torch.randn(sum(outs), generator=g, device=device)
    out = {}
    for name, k, b in zip(names, kernels.split(sizes), biases.split(outs)):
        shape = shapes[name]
        std = math.sqrt(1.0 / math.prod(shape[1:])) / _TRUNC
        if name == "subpixel":
            out[f"{name}.weight"] = k.view(shape) * (std * config["head_gain"])
            out[f"{name}.bias"] = b * config["bias_std"] + config["head_bias"]
        else:
            out[f"{name}.weight"] = k.view(shape) * std
            out[f"{name}.bias"] = b * config["bias_std"]
    return out


def frames(count: int, height: int, width: int, sub: int, seed: int, device):
    """``count`` u8 4:2:0-style frames with hard edges: a luma gradient,
    discs and bars at seeded places and levels, light noise, and smooth
    chroma.  Returns (y (n, H, W), cb, cr (n, H/sub, W/sub))."""
    g = generator(seed, device)
    n_discs = 12
    yy = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(width, device=device, dtype=torch.float32)[None, :]
    u = torch.rand((count, n_discs, 4), generator=g, device=device)
    centre_y, centre_x = u[..., 0] * height, u[..., 1] * width
    radius = (0.02 + 0.1 * u[..., 2]) * min(height, width)
    level = 120.0 * u[..., 3] - 60.0
    luma = (40.0 + 150.0 * xx / width + 40.0 * yy / height).expand(count, height, width).clone()
    for d in range(n_discs):
        inside = ((yy - centre_y[:, d, None, None]) ** 2
                  + (xx - centre_x[:, d, None, None]) ** 2
                  < radius[:, d, None, None] ** 2)
        luma += inside * level[:, d, None, None]
    phase = torch.randint(0, 48, (count, 1, 1), generator=g, device=device)
    luma += 12.0 * ((((xx + phase) // 48) % 2) == ((yy // 96) % 2))
    luma += 3.0 * torch.randn((count, height, width), generator=g, device=device)
    ch, cw = height // sub, width // sub
    cy = torch.arange(ch, device=device, dtype=torch.float32)[:, None] / ch
    cx = torch.arange(cw, device=device, dtype=torch.float32)[None, :] / cw
    shift = torch.rand((count, 2, 1, 1), generator=g, device=device) * 6.0
    cb = 128.0 + 50.0 * torch.sin(6.0 * cx + shift[:, 0]) * torch.cos(3.0 * cy)
    cr = 128.0 + 50.0 * torch.cos(4.0 * cx - shift[:, 1]) * torch.sin(5.0 * cy)
    return tuple(torch.round(p).clamp_(0, 255).to(torch.uint8) for p in (luma, cb, cr))
