"""Weight bridge between the JAX package's flax param tree and the
port's state dict.

The reference's tree (``downloader_tpu/compute/models/upscaler.py:94-102``)
is ``{"params": {"stem": {"kernel", "bias"}, "body_0": ..., "subpixel":
...}}`` with HWIO kernels; the port's :class:`~.models.upscaler.Upscaler`
holds ``<module>.weight`` as OIHW and ``<module>.bias``.  Arrays cross as
numpy, so neither side imports the other's framework.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .models.upscaler import UpscalerConfig, param_paths


def _modules(config: UpscalerConfig):
    return list(dict.fromkeys(p.split("/")[1] for p in param_paths(config)))


def from_flax(tree: Mapping, config: UpscalerConfig = UpscalerConfig()
              ) -> Dict[str, torch.Tensor]:
    """flax ``{"params": {...}}`` (numpy or array-likes) -> the port's
    state dict; HWIO kernels become OIHW."""
    params = tree["params"]
    expected = _modules(config)
    if set(params) != set(expected):
        raise ValueError(f"param tree modules {sorted(params)} != {sorted(expected)}")
    state = {}
    for mod in expected:
        kernel = np.asarray(params[mod]["kernel"], dtype=np.float32)
        state[f"{mod}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))).to(config.param_dtype)
        state[f"{mod}.bias"] = torch.from_numpy(
            np.array(params[mod]["bias"], dtype=np.float32)).to(config.param_dtype)
    return state


def to_flax(state: Mapping[str, torch.Tensor],
            config: UpscalerConfig = UpscalerConfig()) -> Dict:
    """The inverse of :func:`from_flax`: a state dict -> ``{"params":
    {module: {"kernel": HWIO, "bias": ...}}}`` of float32 numpy arrays."""
    params = {}
    for mod in _modules(config):
        weight = state[f"{mod}.weight"].detach().cpu().float().numpy()
        params[mod] = {
            "kernel": np.ascontiguousarray(weight.transpose(2, 3, 1, 0)),
            "bias": state[f"{mod}.bias"].detach().cpu().float().numpy().copy(),
        }
    return {"params": params}
