"""Inference path for RGB frames: u8 frames in, upscaled u8 frames out —
the port of ``downloader_tpu/compute/infer.py``.

u8 RGB / 255 -> the full forward (bf16 convs, plain 3x3 head, pixel
shuffle) -> ``quantize_u8(out * 255)``.  The quantize is the port's one
dispatch point for it, :func:`~.ops.pixel_shuffle.quantize_u8`: on the
card it launches ``csrc/quantize_u8.cu`` on any shape.  (The reference
routes a shape to its Pallas kernel only when the last dim is a multiple
of 128, which 3 RGB channels never are; the function is the same.)
"""

from __future__ import annotations

import functools
from typing import Callable, Mapping

import numpy as np
import torch

from .. import resolve_device
from .models.upscaler import Upscaler, UpscalerConfig
from .ops.pixel_shuffle import quantize_u8
from .pipeline import no_tf32


@functools.lru_cache(maxsize=4)
def _model(config: UpscalerConfig, device: torch.device) -> Upscaler:
    return Upscaler(config).to(device).eval().requires_grad_(False)


def make_infer_fn(config: UpscalerConfig = UpscalerConfig(), device=None,
                  mesh=None) -> Callable:
    """Returns ``infer(params, frames_u8) -> upscaled_u8``.

    ``params`` is a state dict of :class:`~.models.upscaler.Upscaler`
    (e.g. :func:`~.weights.from_flax` of a flax tree); ``frames_u8`` is
    (B, H, W, C) uint8, a tensor or a numpy array; the result is (B,
    H*scale, W*scale, C) uint8 on the device.  The model is built once
    per (config, device); each call runs it on ``params`` as given,
    copying only the tensors that are not on the device yet.

    ``device`` defaults to CUDA and raises without a GPU; pass ``"cpu"``
    for the plain PyTorch path.  A ``mesh`` (the reference's data-parallel
    route) waits for the multi-GPU slice of the port and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "make_infer_fn(mesh=...): data-parallel inference over several "
            "GPUs is not ported yet")
    dev = resolve_device(device)
    model = _model(config, dev)

    @torch.inference_mode()
    def infer(params: Mapping[str, torch.Tensor], frames_u8) -> torch.Tensor:
        if isinstance(frames_u8, np.ndarray):
            frames_u8 = torch.from_numpy(np.ascontiguousarray(frames_u8))
        if frames_u8.dtype != torch.uint8:
            raise TypeError(f"infer takes uint8 frames, got {frames_u8.dtype}")
        weights = {k: v.to(dev) for k, v in params.items()}
        x = frames_u8.to(dev).float() / 255.0
        with no_tf32():
            out = torch.func.functional_call(model, weights, (x,))
        return quantize_u8((out.float() * 255.0).contiguous())

    return infer


def upscale_frames(params: Mapping[str, torch.Tensor], frames_u8,
                   config: UpscalerConfig = UpscalerConfig(),
                   device=None) -> torch.Tensor:
    """Convenience wrapper around :func:`make_infer_fn`."""
    return make_infer_fn(config, device)(params, frames_u8)
