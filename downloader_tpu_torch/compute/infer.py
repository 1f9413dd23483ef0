"""Inference path for RGB frames: u8 frames in, upscaled u8 frames out —
the port of ``downloader_tpu/compute/infer.py``.

u8 RGB / 255 -> the full forward (bf16 convs, plain 3x3 head, pixel
shuffle) -> ``quantize_u8(out * 255)``.  The quantize is the port's one
dispatch point for it, :func:`~.ops.pixel_shuffle.quantize_u8`: on the
card it launches ``csrc/quantize_u8.cu`` on any shape.  (The reference
routes a shape to its Pallas kernel only when the last dim is a multiple
of 128, which 3 RGB channels never are; the function is the same.)

With a ``mesh`` (a :class:`~.parallel.mesh.MeshPlan`) the batch is
data-parallel over the plan's ``data`` devices and the params are
replicated: the batch is zero-padded to a multiple of the data axis and
cut into one block of rows per data coordinate.  In a process group
(one rank per card) each rank runs its own block and the rows are
all-gathered, so every rank returns the whole; a plan of one process
over several devices runs each block on its device in turn and joins
the rows on the plan's first device.  Batch entries are independent, so
the output is byte-identical to the one-device path's.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Mapping, Tuple

import numpy as np
import torch

from .. import resolve_device
from .models import ModelConfig, build_model
from .models.upscaler import UpscalerConfig
from .ops.pixel_shuffle import quantize_u8
from .parallel.mesh import block, gather_global, place, shard_batch
from .pipeline import no_tf32


@functools.lru_cache(maxsize=4)
def _model(config: ModelConfig,
           device: torch.device) -> Tuple[torch.nn.Module, threading.Lock]:
    """The module shared by every caller of one (config, device), built
    from the config's type (:func:`.models.build_model`), and the lock
    that serialises the calls that swap their params into it."""
    return (build_model(config).to(device).eval().requires_grad_(False),
            threading.Lock())


def _forward(config: ModelConfig, params: Mapping[str, torch.Tensor],
             frames: torch.Tensor, dev: torch.device) -> torch.Tensor:
    model, lock = _model(config, dev)
    weights = {k: v.to(dev) for k, v in params.items()}
    x = frames.to(dev).float() / 255.0
    with lock, no_tf32():
        out = torch.func.functional_call(model, weights, (x,))
    return quantize_u8((out.float() * 255.0).contiguous())


def make_infer_fn(config: ModelConfig = UpscalerConfig(), device=None,
                  mesh=None) -> Callable:
    """Returns ``infer(params, frames_u8) -> upscaled_u8``.

    ``params`` is a state dict of the config's model (for
    :class:`~.models.upscaler.Upscaler` e.g. :func:`~.weights.from_flax`
    of a flax tree); ``frames_u8`` is
    (B, H, W, C) uint8, a tensor or a numpy array; the result is (B,
    H*scale, W*scale, C) uint8 on the device.  The model is built once
    per (config, device); each call runs it on ``params`` as given,
    copying only the tensors that are not on the device yet.  Calls on one
    module take turns for the forward pass: ``functional_call`` swaps the
    caller's params into the shared module for its length.

    ``device`` defaults to CUDA and raises without a GPU; pass ``"cpu"``
    for the plain PyTorch path.  ``mesh`` (a plan, in place of
    ``device``) splits the batch over the plan's data devices (module
    docstring); the result lies on the plan's first device, or in a
    process group on this rank's."""
    if mesh is not None and device is not None:
        raise ValueError("pass device or mesh, not both")

    def check(frames_u8) -> torch.Tensor:
        if isinstance(frames_u8, np.ndarray):
            frames_u8 = torch.from_numpy(np.ascontiguousarray(frames_u8))
        if frames_u8.dtype != torch.uint8:
            raise TypeError(f"infer takes uint8 frames, got {frames_u8.dtype}")
        return frames_u8

    if mesh is None:
        dev = resolve_device(device)
        _model(config, dev)  # build the module now, as before the first call

        @torch.inference_mode()
        def infer(params: Mapping[str, torch.Tensor], frames_u8) -> torch.Tensor:
            return _forward(config, params, check(frames_u8), dev)

        return infer

    data, home = mesh.shape["data"], mesh.device

    @torch.inference_mode()
    def infer_on_mesh(params: Mapping[str, torch.Tensor], frames_u8) -> torch.Tensor:
        frames = check(frames_u8)
        n = frames.shape[0]
        pad = -n % data
        if pad:
            frames = torch.cat([frames, frames.new_zeros((pad, *frames.shape[1:]))])
        if mesh.size == 1:
            return _forward(config, params, frames, home)
        if mesh.mesh is not None:  # this rank's rows, then every rank's
            out = _forward(config, params, shard_batch(mesh, frames), home)
            return gather_global(mesh, out, mesh.data_spec)[:n]
        parts = []
        for d in range(data):
            device = mesh.grid[d, 0]
            rows = block(frames, mesh, mesh.data_spec, (d, 0))
            with (torch.cuda.device(device) if device.type == "cuda"
                  else contextlib.nullcontext()):
                out = _forward(config, params, rows, device)
            parts.append(out if out.device == home else place(out, home))
        return torch.cat(parts)[:n]

    return infer_on_mesh


def upscale_frames(params: Mapping[str, torch.Tensor], frames_u8,
                   config: ModelConfig = UpscalerConfig(),
                   device=None) -> torch.Tensor:
    """Convenience wrapper around :func:`make_infer_fn`."""
    return make_infer_fn(config, device)(params, frames_u8)
