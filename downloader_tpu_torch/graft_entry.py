"""Entry points of the port — the counterpart of the repo's
``__graft_entry__.py``.

- :func:`entry` — the upscaler's forward pass and example arguments;
- :func:`dryrun_multichip` — one full train step over an n-device (data
  x model) mesh in n processes (one per device), a second, wider mesh
  fed through a checkpoint save -> reshaped restore, and the upscale
  engine's data-parallel inference over the same devices.

The reference drops to a virtual CPU mesh when fewer chips are visible
than asked (``__graft_entry__.py:63-79``).  Here a dry run on CUDA (the
default) raises, naming the count, when fewer cards are visible; it runs
on the CPU (gloo, n processes of one thread) only when asked with
``device="cpu"``.  Run both over the visible cards::

    python -m downloader_tpu_torch.graft_entry
"""

from __future__ import annotations

import math
import tempfile
from typing import Optional

import numpy as np
import torch

from . import resolve_device


def entry(device=None):
    """Return ``(forward, (params, frames))``: the upscaler's forward
    (``torch.func.functional_call`` of :class:`Upscaler` at
    ``UpscalerConfig()``), its seeded params and a seeded (8, 64, 64, 3)
    batch of low-res frames, on ``device`` (CUDA unless ``"cpu"``)."""
    from .compute.models.upscaler import Upscaler, UpscalerConfig

    dev = resolve_device(device)
    model = Upscaler(UpscalerConfig(), seed=0).to(dev)
    generator = torch.Generator().manual_seed(0)
    frames = torch.rand((8, 64, 64, 3), generator=generator).to(dev)
    params = dict(model.state_dict())

    def forward(params, frames):
        return torch.func.functional_call(model, params, (frames,))

    return forward, (params, frames)


def _one_step(plan, step, state) -> float:
    """One step on the plan's batch (2 rows per data shard); the loss."""
    from .compute.parallel.mesh import shard_batch

    generator = torch.Generator().manual_seed(0)
    batch = plan.shape["data"] * 2
    low = torch.rand((batch, 16, 16, 3), generator=generator)
    high = torch.rand((batch, 32, 32, 3), generator=generator)
    loss = float(step(state, *shard_batch(plan, (low, high))))
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    return loss


def _dryrun_worker(log, device_type: str, model_axis: int, wide: bool,
                   ckpt_dir: str):
    """One rank of the dry run: the step on the (data x model) mesh, then,
    with ``wide``, the save -> restore onto model axis 4 and a step
    there.  Returns ``(mesh, loss, (wide mesh, wide loss) or None)``."""
    from .compute.checkpoint import load_optimizer_state, restore_state, save_state
    from .compute.models.upscaler import Upscaler, UpscalerConfig
    from .compute.parallel.mesh import make_mesh
    from .compute.train import compile_train_step

    config = UpscalerConfig(features=128, depth=3, scale=2)
    plan = make_mesh(model_axis=model_axis, device=device_type)
    step, init_state, _ = compile_train_step(config, mesh=plan)
    state = init_state(0)
    loss = _one_step(plan, step, state)
    second = None
    if wide:
        plan_wide = make_mesh(model_axis=4, device=device_type)
        step_wide, init_wide, _ = compile_train_step(config, mesh=plan_wide)
        save_state(ckpt_dir, 1, state.model.state_dict(),
                   state.optimizer.state_dict(), plan=plan)
        moved = init_wide(0)
        _step, params, opt_state = restore_state(
            ckpt_dir, Upscaler(config, seed=None).state_dict(), plan=plan_wide)
        moved.model.load_state_dict(params)
        load_optimizer_state(moved.optimizer, opt_state)
        second = (plan_wide.shape, _one_step(plan_wide, step_wide, moved))
    return plan.shape, loss, second


def dryrun_multichip(n_devices: int, model_axis: Optional[int] = None,
                     device=None) -> str:
    """Run the FULL training step over an n-device (data x model) mesh,
    one process per device, for one step; print and return the
    reference's ``dryrun_multichip ok: mesh=... loss=...
    infer_checksum=...`` line.

    ``model_axis`` pins the tensor-parallel width; by default it is 2 for
    an even device count, and then, when 4 divides the count, a second
    mesh of model axis 4 is fed through a checkpoint save -> mesh-reshape
    restore and stepped — what a resize between topologies performs.
    Then the upscale engine runs one data-parallel batch over every
    visible card (on the CPU over ``n_devices`` listings of it)."""
    from .compute.models.upscaler import UpscalerConfig
    from .compute.parallel.group import run_group
    from .compute.pipeline import FrameUpscaler

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have "
                           f"{torch.cuda.device_count()}")
    auto = model_axis is None
    if auto:
        model_axis = 2 if n_devices % 2 == 0 else 1
    with tempfile.TemporaryDirectory() as ckpt:
        mesh, loss, second = run_group(
            _dryrun_worker, n_devices, dev.type,
            args=(dev.type, model_axis, auto and n_devices % 4 == 0, ckpt))[0]

    # the other multi-device path the service ships: the upscale stage's
    # data-parallel inference engine (batch split over every device,
    # params replicated)
    engine = FrameUpscaler(config=UpscalerConfig(features=8, depth=2),
                           batch=n_devices, device=dev,
                           devices=["cpu"] * n_devices if dev.type == "cpu" else None)
    if engine.n_devices < n_devices:
        raise RuntimeError(f"inference engine adopted {engine.n_devices} devices")
    batch = engine.batch
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (batch, 16, 16), dtype=np.uint8)
    cb = rng.integers(0, 256, (batch, 8, 8), dtype=np.uint8)
    cr = rng.integers(0, 256, (batch, 8, 8), dtype=np.uint8)
    y2, cb2, cr2 = engine.upscale_batch(y, cb, cr, 2, 2)
    if y2.shape != (batch, 32, 32):
        raise RuntimeError(f"engine output {y2.shape}")
    checksum = int(y2.sum()) + int(cb2.sum()) + int(cr2.sum())

    reshape = (f" reshaped_mesh={second[0]} reshaped_loss={second[1]:.5f}"
               if second else "")
    line = (f"dryrun_multichip ok: mesh={mesh} loss={loss:.5f} "
            f"infer_checksum={checksum}" + reshape)
    print(line, flush=True)
    return line


if __name__ == "__main__":
    fn, args = entry()
    with torch.inference_mode():
        out = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype, flush=True)
    dryrun_multichip(torch.cuda.device_count())
