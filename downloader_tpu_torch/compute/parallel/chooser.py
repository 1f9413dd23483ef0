"""pjit-vs-shard_map chooser — the port of
``downloader_tpu/compute/parallel/chooser.py``.

``choose`` keeps the reference's decision and its reasons, cached per
(plan axis names, grid shape, batch shape, explicit shardings, data
axis), so a hot loop never re-derives it.  ``compile_step`` turns the
decision into a callable.  PyTorch runs eagerly, so no route compiles;
each says who places the shards:

- **jit**: one device; ``fn`` is called as it is.
- **pjit**: the caller placed its per-device shards itself and calls
  ``fn`` on each (the engine does: pinned, non-blocking copies per card;
  the train step does: each rank holds its rows and its channel slice).
  ``fn`` is returned as it is.
- **shard_map**: ``fn`` is a per-shard function; the returned callable
  cuts each argument by its ``in_specs`` entry, runs ``fn`` once per
  ``data`` shard and joins the outputs by ``out_specs`` — in a process
  group on this rank's shard, the outputs all-gathered over the
  ``data`` group so every rank returns the whole; in one process on each
  data row's device in turn, the outputs joined on the first device.
  Specs name only ``data``: splitting over ``model`` is the train
  step's own business (its collectives).

``donate_argnums`` is accepted on every route and changes nothing:
PyTorch's state updates (the train step's params and Adam moments) are
in place already, so an old state is never resident beside the new.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from .mesh import MeshPlan, block, place
from .partition import Spec


@dataclasses.dataclass(frozen=True)
class Decision:
    strategy: str  # "jit" | "pjit" | "shard_map"
    reason: str


_DECISIONS: dict = {}


def _mesh_key(mesh: Optional[MeshPlan]) -> Optional[tuple]:
    if mesh is None:
        return None
    return (tuple(mesh.axis_names), tuple(mesh.grid.shape))


def choose(mesh: Optional[MeshPlan], batch_shape: Optional[Tuple[int, ...]], *,
           explicit_shardings: bool, data_axis: str = "data") -> Decision:
    """Pick the route for one step; cached per (mesh, shape).

    ``batch_shape`` is the leading-dim shape of the batched argument
    (``None`` for shape-polymorphic callers — they get the mesh-level
    answer).  ``explicit_shardings`` says the caller places its shards
    itself — the pjit precondition."""
    key = (_mesh_key(mesh), batch_shape, explicit_shardings, data_axis)
    hit = _DECISIONS.get(key)
    if hit is not None:
        return hit

    if mesh is None or mesh.size == 1:
        decision = Decision("jit", "single device: no mesh to map over")
    elif explicit_shardings:
        decision = Decision(
            "pjit", "explicit shardings provided: let XLA propagate")
    elif batch_shape is None:
        decision = Decision(
            "pjit", "shape-polymorphic: propagate from input placements")
    else:
        data = mesh.shape.get(data_axis, 1)
        if batch_shape[0] % max(1, data) != 0:
            decision = Decision(
                "pjit",
                f"batch {batch_shape[0]} not divisible by "
                f"{data_axis}={data}: pjit pads, shard_map cannot")
        else:
            decision = Decision(
                "shard_map", "even data-parallel batch: per-shard specs")
    _DECISIONS[key] = decision
    return decision


def decision_cache() -> dict:
    """Snapshot of cached decisions (tests pin entries per fixture)."""
    return dict(_DECISIONS)


def clear_decisions() -> None:
    _DECISIONS.clear()


def _as_tuple(specs) -> tuple:
    return (specs,) if isinstance(specs, Spec) else tuple(specs)


def _shard_map(fn: Callable, plan: MeshPlan, in_specs: Sequence[Spec],
               out_specs, data_axis: str) -> Callable:
    single_out = isinstance(out_specs, Spec)
    outs_spec = _as_tuple(out_specs)
    for spec in (*in_specs, *outs_spec):
        if any(axis not in (None, data_axis) for axis in spec):
            raise ValueError(f"shard_map specs split only over {data_axis!r}, "
                             f"got {spec}")
    if plan.mesh is not None:
        shards = [plan.coords]
    else:
        shards = [(d, 0) for d in range(plan.shape[data_axis])]

    def mapped(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"shard_map: {len(args)} arguments, "
                            f"{len(in_specs)} in_specs")
        per_shard = []
        for coords in shards:
            device = plan.grid[coords]
            local = [block(a, plan, s, coords).to(device) if s else a
                     for a, s in zip(args, in_specs)]
            with (torch.cuda.device(device) if device.type == "cuda"
                  else contextlib.nullcontext()):
                out = fn(*local)
            per_shard.append(_as_tuple(out) if not single_out else (out,))
        joined = tuple(_join(plan, [o[i] for o in per_shard], spec, data_axis)
                       for i, spec in enumerate(outs_spec))
        return joined[0] if single_out else joined

    return mapped


def _join(plan: MeshPlan, parts, spec: Spec, data_axis: str) -> torch.Tensor:
    """The whole output from its data shards: concatenated on the dim
    ``spec`` splits (on the first shard's device), all-gathered over the
    data group in a process group; a replicated output is the first
    shard's."""
    import torch.distributed as dist

    if data_axis not in spec:
        return parts[0]
    dim = spec.index(data_axis)
    if plan.mesh is None:
        home = parts[0].device
        return torch.cat([place(p, home) if p.device != home else p
                          for p in parts], dim=dim)
    (mine,) = parts
    gathered = [torch.empty_like(mine) for _ in range(plan.shape[data_axis])]
    dist.all_gather(gathered, mine.contiguous(), group=plan.group(data_axis))
    return torch.cat(gathered, dim=dim)


def compile_step(fn: Callable, mesh: Optional[MeshPlan], *, batch_shape=None,
                 data_axis: str = "data", in_shardings=None, out_shardings=None,
                 in_specs=None, out_specs=None, donate_argnums=()):
    """Route ``fn`` per the cached decision; returns ``(callable,
    decision)``.

    jit and pjit return ``fn`` itself (``in_shardings``/``out_shardings``
    only say that the caller places its shards); shard_map wraps ``fn``
    with the given per-shard specs and raises without them.
    ``donate_argnums`` is accepted on every route (see the module
    docstring)."""
    del out_shardings, donate_argnums  # eager PyTorch: nothing to declare
    decision = choose(mesh, batch_shape,
                      explicit_shardings=in_shardings is not None,
                      data_axis=data_axis)
    if decision.strategy in ("jit", "pjit"):
        return fn, decision
    if in_specs is None or out_specs is None:
        raise ValueError(
            "shard_map chosen but in_specs/out_specs not provided; "
            "pass per-shard specs or place inputs and pass in_shardings")
    return _shard_map(fn, mesh, _as_tuple(in_specs), out_specs,
                      data_axis), decision
