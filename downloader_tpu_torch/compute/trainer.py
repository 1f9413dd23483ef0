"""Training loop: fit the upscaler on Y4M media, self-supervised — the
port of ``downloader_tpu/compute/trainer.py:43-220``.

Decode Y4M media (the format the ``upscale`` path consumes), cut
high-res crops, make the low-res inputs by box-downsampling, and
minimize the reconstruction MSE with the step of :mod:`.train`, saving
checkpoints (:mod:`.checkpoint`) that ``FrameUpscaler(checkpoint_dir=)``
and ``upscale --checkpoint-dir`` load.

The data path is the reference's, in numpy and in the same order, so a
seed yields the same crops byte for byte: every crop converts its whole
frame to RGB on the host first.  That makes the loop host-bound on real
media, as the reference's is.  Batches cross to the card through pinned
buffers with non-blocking copies, and the loss is read back only at log
steps, so the host never waits for the card in between.

Devices, as the reference's ``:145-157``: on one device the loop runs
as above.  Inside a process group of more than one rank (one process
per device: :func:`train_in_group`, or ``torchrun``) it builds a (data
x model) mesh of ``model_axis``, rounds the batch up to the data axis,
and every rank draws the same crop stream and keeps its rows
(:func:`~.parallel.mesh.shard_batch`); rank 0 logs, every rank takes
part in a save and rank 0 writes it.  ``train()`` on CUDA with more than
one visible card and no group starts that group itself, one worker per
card (NCCL), so the ``train`` CLI adopts every card, as the
reference's does.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from .checkpoint import load_optimizer_state, restore_state, save_state
from .models.upscaler import Upscaler, UpscalerConfig
from .parallel.group import run_group
from .parallel.mesh import make_mesh, shard_batch
from .train import compile_train_step
from .video import Y4MReader

# numpy mirror of ops/colorspace's BT.601 full-range inverse (the data
# prep stays on the host, as in the reference)
_YCC2RGB = np.array(
    [
        [1.0, 0.0, 1.402],
        [1.0, -0.344136, -0.714136],
        [1.0, 1.772, 0.0],
    ],
    dtype=np.float32,
)


@dataclasses.dataclass(frozen=True)
class TrainerSettings:
    steps: int = 200
    batch: int = 8
    crop: int = 64  # high-res crop edge; LR input is crop/scale
    learning_rate: float = 1e-3
    checkpoint_dir: Optional[str] = None
    save_every: int = 100
    log_every: int = 20
    seed: int = 0
    model_axis: int = 1
    # model geometry — must match the engine that will load the checkpoint
    scale: int = 2
    features: int = 128
    depth: int = 4


def _frame_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                  sub_h: int, sub_w: int) -> np.ndarray:
    """Planar uint8 YCbCr (subsampled chroma) -> HxWx3 float32 RGB in
    [0, 1]; nearest-neighbor chroma upsample, matching the device path."""
    yf = y.astype(np.float32)
    cbf = cb.astype(np.float32).repeat(sub_h, axis=0).repeat(sub_w, axis=1)
    crf = cr.astype(np.float32).repeat(sub_h, axis=0).repeat(sub_w, axis=1)
    ycc = np.stack([yf, cbf - 128.0, crf - 128.0], axis=-1)
    return np.clip(ycc @ _YCC2RGB.T, 0.0, 255.0) / 255.0


def hr_crop_stream(paths: Sequence[str], crop: int,
                   rng: np.random.Generator) -> Iterator[np.ndarray]:
    """Endless stream of (crop, crop, 3) float32 RGB crops from Y4M files.

    Files cycle; each decoded frame yields one random crop."""
    if not paths:
        raise ValueError("no training media given")
    while True:
        for path in paths:
            with open(path, "rb") as fh:
                reader = Y4MReader(fh)
                sub_h, sub_w = reader.header.subsampling
                if (reader.header.height < crop
                        or reader.header.width < crop):
                    raise ValueError(
                        f"{path}: {reader.header.width}x"
                        f"{reader.header.height} smaller than crop {crop}"
                    )
                for y, cb, cr in reader:
                    rgb = _frame_to_rgb(y, cb, cr, sub_h, sub_w)
                    top = int(rng.integers(0, rgb.shape[0] - crop + 1))
                    left = int(rng.integers(0, rgb.shape[1] - crop + 1))
                    yield rgb[top:top + crop, left:left + crop]


def box_downsample(hr: np.ndarray, scale: int) -> np.ndarray:
    """(..., H, W, 3) -> (..., H/scale, W/scale, 3) by box mean — the
    degradation model pairing LR inputs with HR targets."""
    *lead, h, w, c = hr.shape
    hr = hr.reshape(*lead, h // scale, scale, w // scale, scale, c)
    return hr.mean(axis=(-4, -2))


def discover_media(data: str) -> List[str]:
    """A .y4m file, or a directory scanned (sorted) for .y4m files."""
    if os.path.isfile(data):
        return [data]
    found = sorted(
        os.path.join(data, name)
        for name in os.listdir(data)
        if name.endswith(".y4m")
    )
    if not found:
        raise FileNotFoundError(f"no .y4m media under {data}")
    return found


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A float32 batch onto ``device``: on the card through a pinned
    buffer and a non-blocking copy (the caching host allocator reuses the
    buffer only after the copy has completed)."""
    if device.type == "cpu":
        return torch.from_numpy(arr)
    pinned = torch.empty(arr.shape, dtype=torch.float32, pin_memory=True)
    pinned.numpy()[...] = arr
    return pinned.to(device, non_blocking=True)


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def train(paths: Sequence[str], settings: TrainerSettings = TrainerSettings(),
          log: Optional[Callable[[str], None]] = None, device=None) -> dict:
    """Run the training loop; returns a summary dict (final step/loss).

    Resumes from ``checkpoint_dir``'s latest step when one exists (a
    state saved on one device or on any mesh shape, by this package or,
    as an orbax step, by the JAX package).  A checkpoint directory that
    holds another format, a step that cannot be read or a model of
    another geometry raises rather than starting afresh.  ``device`` defaults to CUDA and
    raises without a GPU; pass ``"cpu"`` for the plain PyTorch path.
    More than one visible card and no process group: the loop runs in a
    group of one worker per card (:func:`train_in_group`)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and _world() == 1 and torch.cuda.device_count() > 1:
        return train_in_group(paths, settings, torch.cuda.device_count(),
                              "cuda", log=log)
    config = UpscalerConfig(
        scale=settings.scale,
        features=settings.features,
        depth=settings.depth,
    )
    scale = config.scale
    if settings.crop % scale:
        raise ValueError(f"crop {settings.crop} not divisible by scale {scale}")

    plan = None
    rank = 0
    if _world() > 1:
        import torch.distributed as dist

        plan = make_mesh(model_axis=settings.model_axis, device=dev)
        rank = dist.get_rank()
    emit = (log or (lambda _line: None)) if rank == 0 else (lambda _line: None)
    # equal shards per data-axis device
    data_axis = plan.shape["data"] if plan is not None else 1
    batch = -(-settings.batch // data_axis) * data_axis

    train_step, init_state, _decision = compile_train_step(
        config, mesh=plan, learning_rate=settings.learning_rate, device=dev)
    state = init_state(settings.seed)

    start_step = 0
    if settings.checkpoint_dir and os.path.isdir(settings.checkpoint_dir):
        whole = (state.model.state_dict() if plan is None
                 else Upscaler(config, seed=None).state_dict())
        try:
            start_step, params, opt_state = restore_state(
                settings.checkpoint_dir, whole, plan=plan)
        except FileNotFoundError:
            pass
        else:
            state.model.load_state_dict(params)
            load_optimizer_state(state.optimizer, opt_state)
            emit(f"resumed from step {start_step}")

    crops = hr_crop_stream(paths, settings.crop, np.random.default_rng(settings.seed))

    def save(step: int) -> None:
        if save_state(settings.checkpoint_dir, step, state.model.state_dict(),
                      state.optimizer.state_dict(), plan=plan):
            emit(f"checkpoint saved at step {step}")

    last_loss = float("nan")
    loss = None
    started = time.monotonic()
    step = start_step
    for step in range(start_step + 1, start_step + settings.steps + 1):
        hr = np.stack([next(crops) for _ in range(batch)])
        lr = box_downsample(hr, scale).astype(np.float32)
        if plan is not None:
            lr_dev, hr_dev = shard_batch(plan, (lr, hr))
        else:
            lr_dev, hr_dev = _to_device(lr, dev), _to_device(hr, dev)
        loss = train_step(state, lr_dev, hr_dev)
        if step % settings.log_every == 0 or step == start_step + 1:
            last_loss = float(loss)
            rate = (step - start_step) / (time.monotonic() - started)
            # signals live in [0,1], so PSNR = -10 log10(MSE) directly
            psnr = -10.0 * np.log10(max(last_loss, 1e-12))
            emit(f"step {step} loss {last_loss:.6f} "
                 f"psnr {psnr:.2f}dB ({rate:.1f} steps/s)")
        if settings.checkpoint_dir and step % settings.save_every == 0:
            save(step)
    if loss is not None:
        last_loss = float(loss)

    if settings.checkpoint_dir and settings.steps:
        save(step)  # a no-op when the loop just saved this step
    return {
        "final_step": step,
        "final_loss": last_loss,
        "final_psnr_db": -10.0 * float(np.log10(max(last_loss, 1e-12))),
        "batch": batch,
        "devices": plan.size if plan is not None else 1,
        "mesh": plan.shape if plan is not None else None,
    }


def _train_worker(log, paths: List[str], settings: TrainerSettings,
                  device_type: str) -> dict:
    return train(paths, settings, log=log, device=device_type)


def train_in_group(paths: Sequence[str], settings: TrainerSettings, world: int,
                   device_type: str = "cuda",
                   log: Optional[Callable[[str], None]] = None,
                   timeout: float = 24 * 3600.0) -> dict:
    """:func:`train` in a new process group of ``world`` ranks, one per
    card (NCCL; ``device_type="cpu"``: gloo, one CPU thread each); rank
    0's log lines reach ``log`` here.  Returns rank 0's summary."""
    return run_group(_train_worker, world, device_type,
                     args=(list(paths), settings, device_type),
                     timeout=timeout, log=log)[0]
