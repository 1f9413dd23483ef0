"""downloader_tpu_torch — the PyTorch/CUDA port of ``downloader_tpu``,
for an NVIDIA H100.

The JAX package ``downloader_tpu`` stays the reference; this package
imports ``torch`` and never JAX or anything of ``downloader_tpu``: it
keeps its own copy of every framework-free module it needs.

``python -m downloader_tpu_torch`` with no arguments runs the staging
service (``app.main``: download -> process -> [upscale] -> upload), as
``python -m downloader_tpu`` does; with a subcommand it runs the port's
CLI (the reference's operator commands, ``upscale SRC DST``, ``train
--data MEDIA``).

- ``app``, ``orchestrator``, ``health``, ``codec``, ``control/``,
  ``fleet/``, ``incident/``, ``mq/``, ``origins/``, ``platform/``,
  ``schemas/``, ``stages/``, ``store/``, ``torrent/``, ``utils/`` — the
  service: copies of the reference's modules, held to them by
  ``tests/test_torch_service_copies.py``; ``stages/upscale.py`` runs the
  port's engine;
- ``cli.py`` — the operator commands (copies of the reference's
  functions) beside the port's ``upscale``/``train``; ``soak/`` — a copy
  of the reference's soak harness, whose rig runs the port's workers;
- ``compute/video.py``, ``compute/transcode.py``,
  ``compute/parallel/transfer.py``, ``compute/overlap_probe.py`` —
  copies of the reference's framework-free compute helpers;
- ``compute/parallel/`` — the (data x model) mesh plan, the partition
  rules and process groups (``group.py``);
  ``graft_entry.py`` — the entry points of ``__graft_entry__.py`` (``entry``,
  ``dryrun_multichip``);
- ``compute/models/``, ``compute/ops/``, ``compute/weights.py`` — the
  model, its ops and the flax <-> torch weight bridge;
- ``compute/csrc/`` + ``compute/kernels/`` — the hand-written CUDA
  kernels (``sm_90a``) and their ``nvcc``/``ctypes`` loader;
- ``compute/pipeline.py`` — the batched frame engine, every branch and
  spatial tiling; one process places a shard of each batch on every
  visible card;
  ``compute/infer.py`` — the RGB inference path, on one device, on a
  process's list of devices, or one rank per card in a process group;
- ``compute/train.py``, ``compute/trainer.py``, ``compute/checkpoint.py``
  — the train step (on one device, or (data x model) in a process
  group), the training loop and the port's own checkpoints;
- ``scripts/head_spike.py`` — the s2d-head kernel against the engine's
  cuDNN head (``python -m downloader_tpu_torch.scripts.head_spike``).

Everything runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

__version__ = "0.1.0"

# backport asyncio pieces the service relies on when the runtime is
# older than 3.11 (no-op otherwise), as the reference does at import
from .utils.compat import install as _install_compat

_install_compat()
del _install_compat


def resolve_device(device=None):
    """The torch device the port runs on: ``cuda`` unless the caller
    passes ``"cpu"`` (or a ``torch.device``).

    There is no silent CPU fallback: with no GPU present and no explicit
    ``"cpu"``, this raises."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
