"""Checkpoints of the training state — the counterpart of
``downloader_tpu/compute/checkpoint.py:28-92``, in the port's own format.

A checkpoint directory holds one subdirectory per step, ``<dir>/<step>/
state.pt``: a ``torch.save`` of ``{"format", "step", "params",
"opt_state"}``, where ``params`` is the model's state dict and
``opt_state`` the optimizer's, every tensor on the CPU.  It keeps
orbax's contract as the JAX package uses it:

- the last :data:`MAX_TO_KEEP` steps are kept, and a step at or below
  the latest is not written again;
- a step is written into a temporary directory and renamed into place,
  so a crash never leaves a half-written step that :func:`latest_step`
  would pick;
- tensors are stored on the CPU, so a state saved from the card restores
  on the CPU and the other way round (orbax's "logical array");
- :func:`restore_state` loads with ``torch.load(..., weights_only=True)``,
  raises ``FileNotFoundError`` when there is no checkpoint and
  ``ValueError`` when the saved params do not fit the model's geometry.

On a mesh (a :class:`~.parallel.mesh.MeshPlan` in a process group)
:func:`save_state` gathers every sharded tensor whole over its axis and
rank 0 writes the same format, and :func:`restore_state` with a ``plan``
gives each rank its block: a mesh state and a single-device state are
interchangeable, and a state saved on one mesh shape restores onto
another (the reshape a resize performs).

A directory may also hold the JAX package's orbax steps
(``<dir>/<step>/`` with ``_CHECKPOINT_METADATA``, ``params/`` and
``opt_state/``), which :mod:`.orbax_reader` reads with numpy alone: a
model trained or a run started by the JAX package is served and resumed
here.  Its params go through :func:`~.weights.from_flax` and its Adam
moments through :func:`~.weights.adam_from_optax`.  :func:`latest_step`
and the keep-last rule count the steps of both formats, and
:func:`save_state` writes only this package's beside them.  An orbax
step that cannot be read raises a ``ValueError`` naming the format and
the file; it is never taken for an empty directory.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
from typing import Any, Callable, List, Mapping, Optional, Tuple

import torch

from .models.upscaler import UpscalerConfig
from .orbax_reader.step import CHECKPOINT_METADATA, ITEMS, read_step
from .parallel.mesh import MeshPlan, gather_global, make_global
from .weights import adam_from_optax, from_flax

FORMAT = "downloader_tpu_torch/checkpoint/1"
MAX_TO_KEEP = 3
STATE_FILE = "state.pt"

# what an orbax step directory of the JAX package holds
_ORBAX_MARKERS = (CHECKPOINT_METADATA, *ITEMS)


def _steps(directory: str) -> List[int]:
    """The committed steps under ``directory``, of either format,
    ascending; raises ``ValueError`` on a step directory of neither."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if not (name.isdigit() and os.path.isdir(path)):
            continue
        if not (os.path.isfile(os.path.join(path, STATE_FILE))
                or any(os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS)):
            raise ValueError(f"{path} holds neither {STATE_FILE} nor an orbax "
                             "step of the JAX package: not a checkpoint")
        steps.append(int(name))
    return sorted(steps)


def _on_cpu(obj: Any) -> Any:
    """``obj`` with every tensor in it detached and on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _on_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_on_cpu(v) for v in obj)
    return obj


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _per_param(opt_state: Mapping[str, Any], names: List[str],
               fn: Callable[[str, torch.Tensor], torch.Tensor]) -> dict:
    """``opt_state`` (an optimizer's state dict, whose state is keyed by
    parameter index) with ``fn(param name, tensor)`` applied to every
    per-parameter tensor of rank > 0 (Adam's moments); step counts pass
    as they are."""
    state = {
        index: {k: fn(names[int(index)], v)
                if isinstance(v, torch.Tensor) and v.ndim > 0 else v
                for k, v in entry.items()}
        for index, entry in opt_state["state"].items()}
    return {**opt_state, "state": state}


def save_state(directory: str, step: int, params: Mapping[str, torch.Tensor],
               opt_state: Mapping[str, Any],
               plan: Optional[MeshPlan] = None) -> bool:
    """Write checkpoint ``step`` under ``directory`` (keeps the last
    :data:`MAX_TO_KEEP`).  ``params`` is the model's state dict,
    ``opt_state`` the optimizer's.  Returns False, writing nothing, when
    ``step`` is not above the latest saved step, as orbax does.  Steps of
    the JAX package's orbax format in ``directory`` count for that rule
    and for the last :data:`MAX_TO_KEEP`, as on orbax's own continued run.

    With a ``plan`` in a process group every rank calls this: each
    sharded tensor is gathered whole over its axis and rank 0 writes;
    every rank returns rank 0's answer."""
    if plan is not None and plan.mesh is not None:
        import torch.distributed as dist

        names = list(params)
        params = {n: gather_global(plan, t, plan.param_spec(n, t))
                  for n, t in params.items()}
        opt_state = _per_param(opt_state, names, lambda n, t: gather_global(
            plan, t, plan.param_spec(n, t)))
        written = [None]
        if dist.get_rank() == 0:
            written[0] = save_state(directory, step, params, opt_state)
        dist.broadcast_object_list(written, src=0)
        return bool(written[0])
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    steps = _steps(directory)
    if steps and step <= steps[-1]:
        return False
    blob = {"format": FORMAT, "step": int(step), "params": _on_cpu(dict(params)),
            "opt_state": _on_cpu(dict(opt_state))}
    tmp = tempfile.mkdtemp(prefix=f".{step}.tmp-", dir=directory)
    try:
        with open(os.path.join(tmp, STATE_FILE), "wb") as fh:
            torch.save(blob, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.rename(tmp, os.path.join(directory, str(step)))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_dir(directory)
    for old in (steps + [step])[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(directory, str(old)))
    return True


def latest_step(directory: str) -> Optional[int]:
    """The newest saved step under ``directory``, or None."""
    steps = _steps(os.path.abspath(directory))
    return steps[-1] if steps else None


def restore_state(directory: str, params_like: Mapping[str, torch.Tensor],
                  step: Optional[int] = None, plan: Optional[MeshPlan] = None
                  ) -> Tuple[int, dict, dict]:
    """Restore ``(step, params, opt_state)`` (the latest step unless
    ``step`` is given), tensors on the CPU, from a step of either format:
    an orbax step of the JAX package comes back as this package's state
    dicts (the flax params through :func:`~.weights.from_flax`, optax's
    Adam state through :func:`~.weights.adam_from_optax`).

    ``params_like`` is a state dict of the whole model (e.g. a fresh
    one): the saved params must have its keys, shapes and dtypes, else
    this raises ``ValueError`` (orbax raises on a shape mismatch too).
    Load ``opt_state`` with :func:`load_optimizer_state`.  With a
    ``plan`` the params and Adam's moments come back as this process's
    blocks on its device (:func:`~.parallel.mesh.shard_params`), on
    whatever mesh shape the state was saved from."""
    directory = os.path.abspath(directory)
    steps = _steps(directory)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        step = steps[-1]
    elif step not in steps:
        raise FileNotFoundError(f"no checkpoint of step {step} under {directory}")
    step_dir = os.path.join(directory, str(step))
    path = os.path.join(step_dir, STATE_FILE)
    if os.path.isfile(path):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(blob, dict) or blob.get("format") != FORMAT:
            raise ValueError(f"{path} is not a {FORMAT} checkpoint")
        params, opt_state = blob["params"], blob["opt_state"]
    else:
        path = f"{step_dir} (an orbax step of the JAX package)"
        params, opt_state = _read_orbax(step_dir)
    wrong = sorted(
        set(params) ^ set(params_like)
        | {k for k in set(params) & set(params_like)
           if (params[k].shape, params[k].dtype)
           != (params_like[k].shape, params_like[k].dtype)})
    if wrong:
        raise ValueError(
            f"{path} does not fit the model's geometry: "
            + ", ".join(f"{k} saved {_describe(params.get(k))}, model "
                        f"{_describe(params_like.get(k))}" for k in wrong))
    if plan is not None:
        names = list(params_like)
        params = {n: make_global(params[n], plan, plan.param_spec(n, params[n]))
                  for n in names}
        opt_state = _per_param(opt_state, names, lambda n, t: make_global(
            t, plan, plan.param_spec(n, t)))
    return step, params, opt_state


def _read_orbax(step_dir: str) -> Tuple[dict, dict]:
    """The params and Adam state of an orbax step, as this package's
    state dicts, in the geometry the step was saved with."""
    try:
        tree = read_step(step_dir)
        params = tree["params"]["params"]
        stem, head = params["stem"]["kernel"], params["subpixel"]["kernel"]
        config = UpscalerConfig(
            scale=math.isqrt(head.shape[3] // stem.shape[2]), features=stem.shape[3],
            depth=1 + sum(name.startswith("body_") for name in params),
            channels=stem.shape[2])
        return (from_flax(tree["params"], config),
                adam_from_optax(tree["opt_state"], config))
    except (KeyError, TypeError, IndexError, ValueError) as err:
        raise ValueError(f"{step_dir} is an orbax step of the JAX package that "
                         f"cannot be read: {err}") from err


def _describe(t: Optional[torch.Tensor]) -> str:
    return "absent" if t is None else f"{tuple(t.shape)} {t.dtype}"


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         opt_state: Mapping[str, Any]) -> None:
    """Load a saved optimizer state dict into ``optimizer``, keeping the
    optimizer's own hyperparameters and implementation (learning rate,
    betas, eps, fused or not): only the moments and step counts come from
    the checkpoint, as optax's state holds only those.  Tensors move to
    the parameters' device."""
    current = optimizer.state_dict()["param_groups"]
    saved = opt_state["param_groups"]
    if [len(g["params"]) for g in current] != [len(g["params"]) for g in saved]:
        raise ValueError("the saved optimizer state holds other parameter groups")
    groups = [{**{k: v for k, v in cur.items() if k != "params"},
               "params": old["params"]} for cur, old in zip(current, saved)]
    optimizer.load_state_dict({"state": opt_state["state"], "param_groups": groups})
