"""Plain float32 training steps of the upscaler, and the crops the
trainer draws, worked out again from the clip on disk.

Crops: the clip's frames in order, cycling; each frame converted whole
to RGB in [0, 1] (chroma repeated to full size, the BT.601 full-range
inverse, clipped to 0..255), then one crop at a place drawn from
``numpy.random.default_rng(seed)`` (row, then column).  The low-res
input is the crop's box mean over ``scale`` x ``scale``.

A step: the model's forward, the mean squared error over every value,
its gradients, and Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected),
all in float32 with TF32 off.  ``precision="fp8"`` runs the forward as
the control (:mod:`.upscaler`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .upscaler import YCC2RGB, forward

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def read_y4m(path: str) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Every frame of a 4:2:0 Y4M file as u8 (y, cb, cr) planes."""
    with open(path, "rb") as fh:
        head = fh.readline().split()
        fields = {p[:1]: p[1:] for p in head[1:]}
        width, height = int(fields[b"W"]), int(fields[b"H"])
        sizes = (height * width, (height // 2) * (width // 2))
        frames = []
        while fh.readline():
            y = np.frombuffer(fh.read(sizes[0]), np.uint8).reshape(height, width)
            cb, cr = (np.frombuffer(fh.read(sizes[1]), np.uint8)
                      .reshape(height // 2, width // 2) for _ in range(2))
            frames.append((y, cb, cr))
    return frames


def to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    def full(p):
        return p.astype(np.float32).repeat(2, axis=0).repeat(2, axis=1)

    ycc = np.stack([y.astype(np.float32), full(cb) - 128.0, full(cr) - 128.0], -1)
    rgb = ycc @ np.asarray(YCC2RGB, dtype=np.float32).T
    return np.clip(rgb, 0.0, 255.0) / 255.0


def crops(path: str, crop: int, seed: int, count: int) -> np.ndarray:
    """The first ``count`` (crop, crop, 3) float32 crops the trainer draws."""
    frames = read_y4m(path)
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        for frame in frames:
            rgb = to_rgb(*frame)
            top = int(rng.integers(0, rgb.shape[0] - crop + 1))
            left = int(rng.integers(0, rgb.shape[1] - crop + 1))
            out.append(rgb[top:top + crop, left:left + crop])
            if len(out) == count:
                break
    return np.stack(out)


def box_downsample(hr: np.ndarray, scale: int) -> np.ndarray:
    n, h, w, c = hr.shape
    return hr.reshape(n, h // scale, scale, w // scale, scale, c).mean(axis=(2, 4))


def steps(weights: Dict[str, torch.Tensor], batches, scale: int, depth: int,
          learning_rate: float, precision: Optional[str] = None):
    """Adam steps from ``weights`` over ``batches`` of (low-res, high-res)
    NHWC float32 arrays.  Returns the losses, the first step's gradients
    and the parameters after the last step."""
    device = next(iter(weights.values())).device
    params = {k: v.detach().float().clone().requires_grad_(True)
              for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first = [], None
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for t, (low, high) in enumerate(batches, 1):
            x = torch.from_numpy(np.ascontiguousarray(low)).to(device).permute(0, 3, 1, 2)
            target = torch.from_numpy(np.ascontiguousarray(high)).to(device).permute(0, 3, 1, 2)
            pred = forward(params, x, scale, depth, precision)
            loss = torch.mean((pred - target) ** 2)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            with torch.no_grad():
                for k, p in params.items():
                    g = grads[k]
                    m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                    v2[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                    m_hat = m[k] / (1 - BETA1 ** t)
                    v_hat = v2[k] / (1 - BETA2 ** t)
                    p.sub_(learning_rate * m_hat / (v_hat.sqrt() + EPS))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    return losses, first, {k: p.detach() for k, p in params.items()}


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              counted) -> Dict[str, float]:
    """Each leaf's gap between two norms, | |got| - |want| |, over the
    larger of that leaf's reference norm and the median leaf's."""
    norms = {k: float(want[k].norm()) for k in counted}
    median = float(np.median(list(norms.values())))
    return {k: abs(float(got[k].norm()) - norms[k]) / max(norms[k], median)
            for k in counted}


def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             counted) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(got, want, counted).values())


def counted_leaves(first_grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is more than rounding: at least a
    thousandth of the median leaf's norm."""
    norms = {k: float(g.norm()) for k, g in first_grads.items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n >= floor and not math.isnan(n)]
