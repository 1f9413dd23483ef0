"""The upscale compute plane on PyTorch/CUDA.

- ``models/``   — the ESPCN-style upscaler (bf16 compute, NHWC at the
                  public boundary)
- ``ops/``      — layout, colorspace and s2d-head ops; the quantize and
                  s2d-tail ops launch hand-written CUDA kernels on a CUDA
                  tensor and run their plain PyTorch versions on a CPU one
- ``kernels/``  — builds ``csrc/*.cu`` with ``nvcc`` and binds them with
                  ``ctypes``
- ``pipeline.py`` — the batched frame engine the ``upscale`` CLI drives
- ``train.py``, ``trainer.py``, ``checkpoint.py`` — the train step, the
                  training loop the ``train`` CLI drives, and the
                  checkpoints both commands share
"""
