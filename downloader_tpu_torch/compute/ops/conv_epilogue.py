"""A conv's epilogue: its bias, then a relu and a residual add where the
layer has them, in flax's rounding order (``models/upscaler.py``'s
docstring): ``bf16(y + b)``, ``relu``, ``bf16(t + x)``.

:func:`conv_epilogue_plain` is the three PyTorch ops themselves, which
autograd can differentiate.  :func:`conv_epilogue` is one pass of the
hand-written ``csrc/conv_epilogue.cu`` over the conv's output on the
card, in place, with the same roundings in the same order, so the same
bytes; it has no backward.  A CPU tensor takes the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor, relu: bool = False,
                        residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y + bias[:, None, None]``, then ``F.relu`` where ``relu``, then
    ``+ residual`` where given, each rounded to ``y``'s dtype: NCHW
    ``y``, (C,) ``bias``."""
    out = y + bias[:, None, None]
    if relu:
        out = F.relu(out)
    return out if residual is None else out + residual


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, relu: bool = False,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`conv_epilogue_plain`'s result, computed in place over ``y``
    on the card.

    ``y`` is a conv's fresh (B, C, H, W) bf16 output in channels_last
    (NHWC in memory), ``bias`` (C,) bf16, ``residual`` (a relu's only)
    bf16 laid out as ``y``.  A CUDA ``y`` is overwritten with the result
    by one launch of ``csrc/conv_epilogue.cu`` on its device's current
    stream and returned; the wrapper raises on any other dtype, layout,
    shape or device, and on operands that need a gradient, since the
    kernel has none.  The C entry refuses a residual without a relu and
    more channels than a block holds, and :func:`kernels.check` raises
    ``RuntimeError`` for it.  ``conv_epilogue.launches`` counts its
    launches.  A CPU ``y`` takes :func:`conv_epilogue_plain`."""
    if y.device.type == "cpu":
        return conv_epilogue_plain(y, bias, relu, residual)
    if y.device.type != "cuda":
        raise ValueError(f"conv_epilogue: unsupported device {y.device}")
    operands = {"y": y, "bias": bias}
    if residual is not None:
        operands["residual"] = residual
    kernels.same_device("conv epilogue kernel", **operands)
    for name, t in operands.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"conv epilogue kernel takes bfloat16 {name}, got {t.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands.values()):
        raise RuntimeError("conv epilogue kernel has no backward: run it with "
                           "grad off, or take conv_epilogue_plain")
    if y.ndim != 4 or not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv epilogue kernel needs a 4-d channels_last y, got "
                         f"shape {tuple(y.shape)} strides {y.stride()}")
    channels = y.shape[1]
    if tuple(bias.shape) != (channels,) or not bias.is_contiguous():
        raise ValueError(f"conv epilogue kernel needs a contiguous ({channels},) "
                         f"bias, got {tuple(bias.shape)}")
    if residual is not None:
        if (residual.shape != y.shape
                or not residual.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError("conv epilogue kernel needs a channels_last residual "
                             f"of y's shape {tuple(y.shape)}, got "
                             f"{tuple(residual.shape)} strides {residual.stride()}")
        if residual.data_ptr() == y.data_ptr():
            raise ValueError("conv epilogue kernel writes y: the residual must "
                             "be another tensor")
    if y.numel():
        kernels.launch(kernels.function("conv_epilogue"), "conv_epilogue", y.device,
                       y.data_ptr(), bias.data_ptr(),
                       None if residual is None else residual.data_ptr(),
                       y.numel(), channels, int(relu))
        kernels.count_launch(conv_epilogue)
    return y


conv_epilogue.launches = 0
