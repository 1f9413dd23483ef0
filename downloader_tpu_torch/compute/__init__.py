"""The upscale compute plane on PyTorch/CUDA.

- ``models/``   — the ESPCN-style upscaler (bf16 compute, NHWC at the
                  public boundary)
- ``ops/``      — layout, colorspace and s2d-head ops; the quantize and
                  s2d-tail ops launch hand-written CUDA kernels on a CUDA
                  tensor and run their plain PyTorch versions on a CPU one
- ``kernels/``  — builds ``csrc/*.cu`` with ``nvcc`` and binds them with
                  ``ctypes``
- ``parallel/``  — mesh plans, partition rules, the pjit/shard_map
                  chooser, process groups, transfers and hop billing
- ``pipeline.py`` — the batched frame engine the ``upscale`` CLI drives,
                  data-parallel over its devices
- ``train.py``, ``trainer.py``, ``checkpoint.py`` — the train step, the
                  training loop the ``train`` CLI drives, and the
                  checkpoints both commands share
- ``orbax_reader/`` — the JAX package's orbax steps read with numpy
                  alone (zstd, OCDBT, zarr v2), which ``checkpoint.py``
                  restores beside its own
"""
