"""Regex -> partition spec tables for the model's params — the port of
``downloader_tpu/compute/parallel/partition.py``.

``match_partition_rules`` gives every entry of a state dict a
:class:`Spec` by the first rule whose regex hits its name.  The
reference's two hard edges are kept:

- an UNMATCHED param raises: silently replicating a tensor the table
  forgot is how sharding rules drift.  A param that should be
  replicated says so with an explicit rule;
- rank-0 tensors (an optimizer's step count) are always ``Spec()``; no
  rule can shard them.

``UPSCALER_RULES`` is the table for the port's :class:`Upscaler`, keyed
on its state-dict names (``stem.weight``, ``body_{i}.bias``,
``subpixel.*``).  The trunk convs split their output channels over
``model``, their biases likewise, and the sub-pixel head stays
replicated (its ``scale^2 * channels`` outputs do not divide by the
usual model-axis sizes).  Every upscaler param matches exactly one rule,
which ``tests/test_torch_parallel.py`` holds.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple


class Spec(tuple):
    """How one tensor lies on a (data x model) mesh, the counterpart of
    ``jax.sharding.PartitionSpec``: entry ``i`` is ``None`` (dim ``i``
    whole on every device) or a mesh axis name (dim ``i`` split into
    equal contiguous blocks over that axis).  Dims beyond the entries are
    whole; ``Spec()`` is replicated.

    The layouts differ from the reference's: torch keeps a conv weight
    as OIHW where flax keeps HWIO, so the reference's ``P(None, None,
    None, "model")`` (cout, last in HWIO) is ``Spec("model", None, None,
    None)`` (cout, first in OIHW) here; a bias's ``P("model")`` is
    ``Spec("model")``."""

    def __new__(cls, *dims: Optional[str]):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"

    def axis_of(self, dim: int) -> Optional[str]:
        """The mesh axis dim ``dim`` is split over, or None."""
        return self[dim] if dim < len(self) else None


Rules = Sequence[Tuple[str, Spec]]

UPSCALER_RULES: Rules = (
    # sub-pixel head: replicated (channel count indivisible by model axis)
    (r"^subpixel\.(weight|bias)$", Spec()),
    # trunk conv weights (cout, cin, kh, kw): split cout over `model`
    (r"^(stem|body_\d+)\.weight$", Spec("model", None, None, None)),
    # trunk biases (cout,): follow their weights' channel split
    (r"^(stem|body_\d+)\.bias$", Spec("model")),
)


def spec_for(rules: Rules, name: str, value) -> Spec:
    """The spec of one tensor; raises if no rule matches.

    ``name`` is its state-dict key; ``value`` only needs ``ndim``."""
    if getattr(value, "ndim", None) == 0:
        return Spec()
    for pattern, spec in rules:
        if re.search(pattern, name):
            return spec
    raise ValueError(f"Partition rule not found for param: {name}")


def match_partition_rules(rules: Rules, params: Mapping) -> Dict[str, Spec]:
    """A state dict (name -> tensor) -> name -> :class:`Spec`: first match
    wins, rank-0 tensors replicate, unmatched names raise."""
    return {name: spec_for(rules, name, value) for name, value in params.items()}


def rule_audit(rules: Rules, params: Mapping) -> Dict[str, List[str]]:
    """Name -> every rule pattern that matches it (diagnostics: the
    exactly-one-match test asserts every list has length 1); rank-0
    tensors bypass the table."""
    return {name: [pat for pat, _ in rules if re.search(pat, name)]
            for name, value in params.items()
            if getattr(value, "ndim", None) != 0}
