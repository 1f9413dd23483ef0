"""downloader_tpu_torch — the PyTorch/CUDA port of ``downloader_tpu``'s
compute plane, for an NVIDIA H100.

The JAX package ``downloader_tpu`` stays the reference; this package
imports ``torch`` and never JAX or anything of ``downloader_tpu``: it
keeps its own copy of every framework-free helper it needs.  What is
ported so far is the compute plane's inference and training, reached
through the CLI (``python -m downloader_tpu_torch upscale SRC DST``,
``python -m downloader_tpu_torch train --data MEDIA``):

- ``compute/video.py``, ``compute/transcode.py``, ``utils/stale.py``,
  ``compute/parallel/transfer.py`` — copies of the reference's
  framework-free modules;
- ``compute/models/``, ``compute/ops/``, ``compute/weights.py`` — the
  model, its ops and the flax <-> torch weight bridge;
- ``compute/csrc/`` + ``compute/kernels/`` — the hand-written CUDA
  kernels (``sm_90a``) and their ``nvcc``/``ctypes`` loader;
- ``compute/pipeline.py`` — the batched frame engine, every branch and
  spatial tiling; ``compute/infer.py`` — the RGB inference path;
- ``compute/train.py``, ``compute/trainer.py``, ``compute/checkpoint.py``
  — the train step, the training loop and the port's own checkpoints;
- ``scripts/head_spike.py`` — the s2d-head kernel against the engine's
  cuDNN head (``python -m downloader_tpu_torch.scripts.head_spike``).

Everything runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

__version__ = "0.1.0"


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
