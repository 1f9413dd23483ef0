"""The flagship model: an ESPCN-style sub-pixel video-frame upscaler
(conv feature extraction + sub-pixel pixel shuffle), the port of
``downloader_tpu/compute/models/upscaler.py``.

The public layout is NHWC, as in the reference, so tests and the weight
bridge compare like with like.  Inside, the NHWC tensor is viewed as
NCHW with ``permute(0, 3, 1, 2)`` — a channels_last view, zero-copy —
and cuDNN runs the convs in that layout.

Rounding follows flax ``nn.Conv`` with ``dtype=compute_dtype``: input and
kernel cast to the compute dtype, conv, output rounded to it, ``+ bias``
in it, then ``relu`` and the residual ``+ x`` in it.  The bias is never
passed into ``conv2d`` — cuDNN would add it before the output rounding.

Those three steps after each conv are its epilogue
(:mod:`..ops.conv_epilogue`).  While autograd records (the train step)
they are PyTorch's own ops; with grad off (the engine and ``infer`` run
under ``torch.inference_mode()``) a bf16 model runs them as one
hand-written pass on the card, which gives the same bytes and has no
backward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_epilogue import conv_epilogue, conv_epilogue_plain
from ..ops.pixel_shuffle import pixel_shuffle


@dataclasses.dataclass(frozen=True)
class UpscalerConfig:
    scale: int = 2              # spatial upscale factor
    features: int = 128         # conv width
    depth: int = 4              # number of hidden conv layers
    channels: int = 3           # RGB
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16


class Conv(nn.Module):
    """A SAME conv holding an OIHW ``weight`` and a ``bias``, applied in
    flax's rounding order (module docstring)."""

    def __init__(self, c_in: int, c_out: int, size: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, size, size, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(c_out, dtype=dtype))
        self.padding = size // 2

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype,
                relu: bool = False, residual: Optional[torch.Tensor] = None,
                epilogue=conv_epilogue_plain) -> torch.Tensor:
        """``x``: NCHW (channels_last) in ``compute_dtype``.  The conv,
        then ``epilogue`` on its output: the bias, and a relu and ``+
        residual`` where asked (:mod:`..ops.conv_epilogue`)."""
        y = F.conv2d(x, self.weight.to(compute_dtype), None, padding=self.padding)
        return epilogue(y, self.bias.to(compute_dtype), relu, residual)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults: lecun-normal kernel (truncated normal at two
        standard deviations, std = sqrt(1/fan_in) / .8796...), zero bias."""
        fan_in = self.weight[0].numel()
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            self.bias.zero_()


class Upscaler(nn.Module):
    """(B, H, W, C) -> (B, H*scale, W*scale, C)

    :meth:`backbone` exposes the pre-shuffle sub-pixel maps
    (B, H, W, C*scale^2); :meth:`trunk` the pre-head features
    (B, H, W, features) that the engine's s2d head consumes.  Submodules
    ``stem``, ``body_{i}`` and ``subpixel`` mirror the reference's param
    tree (see :mod:`..weights`).

    Seeded init draws from an explicit ``torch.Generator`` with flax's
    default distributions; it does NOT reproduce the numbers flax draws
    for the same seed (different generators), so parity with the
    reference needs weights bridged from its param tree.
    """

    def __init__(self, config: UpscalerConfig = UpscalerConfig(),
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        cfg = config
        self.stem = Conv(cfg.channels, cfg.features, 5, cfg.param_dtype)
        for i in range(cfg.depth - 1):
            setattr(self, f"body_{i}",
                    Conv(cfg.features, cfg.features, 3, cfg.param_dtype))
        # project to scale^2 * channels sub-pixel maps
        self.subpixel = Conv(cfg.features, cfg.channels * cfg.scale * cfg.scale,
                             3, cfg.param_dtype)
        generator = torch.Generator().manual_seed(0 if seed is None else seed)
        for conv in self.convs():
            conv.reset_parameters(generator)

    def convs(self) -> List[Conv]:
        body = [getattr(self, f"body_{i}") for i in range(self.config.depth - 1)]
        return [self.stem, *body, self.subpixel]

    def _epilogue(self):
        """PyTorch's ops while autograd records (the kernel has no
        backward) or in a compute dtype other than bf16, else
        :func:`conv_epilogue` (the kernel on the card)."""
        if torch.is_grad_enabled() or self.config.compute_dtype != torch.bfloat16:
            return conv_epilogue_plain
        return conv_epilogue

    def _trunk_nchw(self, frames: torch.Tensor) -> torch.Tensor:
        dt = self.config.compute_dtype
        epilogue = self._epilogue()
        x = frames.to(dt).permute(0, 3, 1, 2)
        x = self.stem(x, dt, relu=True, epilogue=epilogue)
        for conv in self.convs()[1:-1]:
            # residual keeps deep stacks trainable
            x = conv(x, dt, relu=True, residual=x, epilogue=epilogue)
        return x

    def trunk(self, frames: torch.Tensor) -> torch.Tensor:
        """Stem + residual body: the pre-head feature maps, NHWC."""
        return self._trunk_nchw(frames).permute(0, 2, 3, 1)

    def backbone(self, frames: torch.Tensor) -> torch.Tensor:
        x = self._trunk_nchw(frames)
        return self.subpixel(x, self.config.compute_dtype,
                             epilogue=self._epilogue()).permute(0, 2, 3, 1)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(self.backbone(frames), self.config.scale)


def param_paths(config: UpscalerConfig = UpscalerConfig()) -> "list[str]":
    """Every param leaf path (``/``-joined, under the flax ``params``
    collection) of the reference model — the keys the weight bridge maps
    onto this module's ``<module>.weight``/``<module>.bias``."""
    mods = ["stem"] + [f"body_{i}" for i in range(config.depth - 1)]
    mods.append("subpixel")
    return [f"params/{m}/{leaf}" for m in mods for leaf in ("kernel", "bias")]
