"""Device mesh and sharding plan for the compute plane — the port of
``downloader_tpu/compute/parallel/mesh.py``.

Two mesh axes, as in the reference:

- ``data``: data parallelism; the frame batch is split over this axis
  and the train step's gradients are averaged over it;
- ``model``: tensor parallelism; the trunk convs' output channels are
  split over this axis (:data:`~.partition.UPSCALER_RULES`), so each
  device holds 1/T of every trunk kernel.

The reference is single-controller on one host (one process drives every
chip) and multi-controller across hosts.  The port keeps both shapes:

- **in a process group** (one process per device, ``torch.distributed``
  initialized: NCCL on cards, gloo on the CPU) the plan spans the whole
  group and holds its ``DeviceMesh`` and the ``data``/``model`` groups;
  the training path runs here;
- **without one** the plan is one process's list of devices (a device
  may be listed more than once): the inference engine's and ``infer``'s
  data parallelism runs here, one process placing a shard on each.

:func:`make_global`, :func:`shard_params` and :func:`shard_batch` follow
the reference's multi-controller recipe: every process holds the same
host copy (same seed, same input stream) and keeps its own block of it —
its rows of a batch, its channel slice of a kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import resolve_device
from .partition import UPSCALER_RULES, Spec, spec_for

AXES = ("data", "model")


def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


@dataclasses.dataclass(frozen=True, eq=False)
class MeshPlan:
    """A (data x model) grid of torch devices; ``mesh`` is the
    ``DeviceMesh`` of the process group the plan spans, or None for a
    plan of one process's devices."""

    grid: np.ndarray
    mesh: Optional[object] = None
    axis_names: Tuple[str, str] = AXES

    @classmethod
    def over(cls, devices: Sequence, model_axis: int = 1) -> "MeshPlan":
        """A plan of one process over ``devices`` (torch devices or
        names; repeats allowed), ``model_axis`` wide."""
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len(devices) % model_axis:
            raise ValueError(f"{len(devices)} devices not divisible by model "
                             f"axis {model_axis}")
        grid = np.empty(len(devices), dtype=object)
        grid[:] = devices
        return cls(grid.reshape(len(devices) // model_axis, model_axis))

    @property
    def shape(self) -> Dict[str, int]:
        """``{"data": D, "model": T}``, as ``dict(mesh.shape)`` reads in
        the reference."""
        return dict(zip(self.axis_names, self.grid.shape))

    @property
    def size(self) -> int:
        return int(self.grid.size)

    @property
    def coords(self) -> Tuple[int, int]:
        """This process's (data, model) coordinate; (0, 0) for a plan of
        one process."""
        if self.mesh is None:
            return (0, 0)
        d, m = self.mesh.get_coordinate()
        return (int(d), int(m))

    @property
    def device(self) -> torch.device:
        """This process's device (the first one for a plan of one
        process)."""
        return self.grid[self.coords]

    def group(self, axis: str):
        """The process group along ``axis`` that holds this process, or
        None for a plan of one process."""
        return None if self.mesh is None else self.mesh.get_group(axis)

    @property
    def data_spec(self) -> Spec:
        """Batches: the leading (batch) dim split over ``data``."""
        return Spec("data")

    def param_spec(self, name: str, value) -> Spec:
        """Tensor-parallel param layout, resolved through
        :data:`~.partition.UPSCALER_RULES` (an upscaler param the table
        does not know raises instead of replicating)."""
        return spec_for(UPSCALER_RULES, name, value)


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1,
              device=None) -> MeshPlan:
    """Build a (data x model) plan over ``n_devices`` devices.

    In a process group the plan spans the group (one device per rank;
    ``n_devices`` defaults to, and may not differ from, the world size)
    and holds its ``DeviceMesh``.  Without one it is this process's
    first ``n_devices`` visible devices of ``device``'s type: every card
    for ``cuda`` (the default, which raises without a card), the one CPU
    for ``"cpu"``."""
    dev = resolve_device(device)
    if _distributed():
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size()
        n = n_devices or world
        if n > world:
            raise ValueError(f"asked for {n} devices, have {world}")
        if n != world:
            raise ValueError(f"a plan in a process group spans the group: "
                             f"asked for {n} devices of {world}")
        if n % model_axis != 0:
            raise ValueError(f"{n} devices not divisible by model axis {model_axis}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        names = [None] * world
        dist.all_gather_object(names, str(dev))
        mesh = init_device_mesh(dev.type, (n // model_axis, model_axis),
                                mesh_dim_names=AXES)
        plan = MeshPlan.over(names, model_axis)
        return dataclasses.replace(plan, mesh=mesh)
    visible = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    n = n_devices or len(visible)
    if n > len(visible):
        raise ValueError(f"asked for {n} devices, have {len(visible)}")
    if n % model_axis != 0:
        raise ValueError(f"{n} devices not divisible by model axis {model_axis}")
    return MeshPlan.over(visible[:n], model_axis)


def block(value, plan: MeshPlan, spec: Spec,
          coords: Tuple[int, int]) -> torch.Tensor:
    """The block of ``value`` (a tensor or array) that the device at
    ``coords`` holds under ``spec``: each split dim narrowed to the
    coordinate's equal share.  A view where the value is a tensor."""
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        parts = plan.shape[axis]
        if t.shape[dim] % parts:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split "
                             f"evenly over {axis}={parts}")
        share = t.shape[dim] // parts
        t = t.narrow(dim, coords[plan.axis_names.index(axis)] * share, share)
    return t


def place(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device``; from the host to a card
    through a pinned buffer and a non-blocking copy (the caching host
    allocator reuses the buffer only after the copy has completed)."""
    t = t.contiguous()
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


def make_global(value, plan: MeshPlan, spec: Spec = Spec()) -> torch.Tensor:
    """This process's block of a value every process holds identically,
    on its device: the rows of its ``data`` coordinate, the channel slice
    of its ``model`` coordinate, as ``spec`` says.  A plan of one device
    gets the whole value.  On a plan of one process over several devices
    the caller places a shard on each device itself (the engine cuts its
    pinned batch; ``infer`` takes each device's :func:`block`), so such
    a plan raises here."""
    if plan.mesh is None and plan.size > 1:
        raise ValueError("make_global takes a plan in a process group or of "
                         "one device; a plan of one process over "
                         f"{plan.size} devices places its shards itself")
    return place(block(value, plan, spec, plan.coords), plan.device)


def shard_params(plan: MeshPlan, params: Mapping) -> Dict[str, torch.Tensor]:
    """Each param of a state dict as this process's block under the
    plan's rules (trunk weights and biases: its channel slice; the rest
    whole)."""
    return {name: make_global(value, plan, plan.param_spec(name, value))
            for name, value in params.items()}


def shard_batch(plan: MeshPlan, batch):
    """This process's rows of a batch (an array, or a tuple, list or dict
    of them) on its device."""
    if isinstance(batch, dict):
        return {k: shard_batch(plan, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(plan, v) for v in batch)
    return make_global(batch, plan, plan.data_spec)


def gather_global(plan: MeshPlan, t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The inverse of :func:`make_global`: the whole tensor from every
    process's block, on every process (a collective over each split
    axis's group; every process must call it)."""
    import torch.distributed as dist

    for dim, axis in enumerate(spec):
        if axis is None or plan.shape[axis] == 1:
            continue
        if plan.mesh is None:
            raise ValueError("gather_global needs a plan in a process group")
        parts = [torch.empty_like(t) for _ in range(plan.shape[axis])]
        dist.all_gather(parts, t.contiguous(), group=plan.group(axis))
        t = torch.cat(parts, dim=dim)
    return t
