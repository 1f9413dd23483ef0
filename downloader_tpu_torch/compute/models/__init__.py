"""The upscaler models, and the one place that builds a model from its
configuration (the engine and ``infer`` both do).

- ``espcn``: :class:`~.upscaler.Upscaler`, the ESPCN-style flagship
  (scale, features and depth from ``instance.upscale.*``);
- ``swinir-m-x4-real``: :class:`~.swinir.SwinIR` at the published
  SwinIR-M x4 real-world settings (serving only).
"""

from __future__ import annotations

from typing import Optional, Union

from .swinir import SwinIR, SwinIRConfig
from .upscaler import Upscaler, UpscalerConfig

ModelConfig = Union[UpscalerConfig, SwinIRConfig]

MODELS = ("espcn", "swinir-m-x4-real")


def model_config(name: str, scale: int = 2, features: int = 128,
                 depth: int = 4) -> ModelConfig:
    """The configuration an operator selects by ``name``; ``scale``,
    ``features`` and ``depth`` apply to ``espcn`` only."""
    if name == "espcn":
        return UpscalerConfig(scale=scale, features=features, depth=depth)
    if name == "swinir-m-x4-real":
        return SwinIRConfig()
    raise ValueError(f"unknown upscale model {name!r}: choose one of "
                     f"{', '.join(MODELS)}")


def build_model(config: ModelConfig, seed: Optional[int] = 0):
    """The model of ``config``'s type, seeded from ``seed``."""
    if isinstance(config, SwinIRConfig):
        return SwinIR(config, seed=seed)
    return Upscaler(config, seed=seed)


def require_trainable(config: ModelConfig) -> None:
    """Raise unless the trainer can fit ``config``'s model: SwinIR is
    served only."""
    if isinstance(config, SwinIRConfig):
        raise ValueError("SwinIR is served only: the trainer and its "
                         "checkpoints fit the espcn upscaler")
