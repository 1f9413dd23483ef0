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

The JAX package's orbax steps cannot be read here (that needs orbax and
tensorstore): a directory holding them raises a ``ValueError`` that
names the format, and is never taken for an empty one.  A model trained
by the JAX package reaches the port through
:func:`~.weights.from_flax`, in code that holds both packages.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, List, Mapping, Optional, Tuple

import torch

FORMAT = "downloader_tpu_torch/checkpoint/1"
MAX_TO_KEEP = 3
STATE_FILE = "state.pt"

# what an orbax step directory of the JAX package holds
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "params", "opt_state")


def _steps(directory: str) -> List[int]:
    """The committed steps under ``directory``, ascending; raises
    ``ValueError`` on a step directory of another format."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if not (name.isdigit() and os.path.isdir(path)):
            continue
        if os.path.isfile(os.path.join(path, STATE_FILE)):
            steps.append(int(name))
        elif any(os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
            raise ValueError(
                f"{path} is an orbax checkpoint of the JAX package; this "
                f"package reads only its own format (<dir>/<step>/"
                f"{STATE_FILE}). Convert the params with "
                "downloader_tpu_torch.compute.weights.from_flax")
        else:
            raise ValueError(f"{path} holds no {STATE_FILE}: not a "
                             "checkpoint of this package")
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


def save_state(directory: str, step: int, params: Mapping[str, torch.Tensor],
               opt_state: Mapping[str, Any]) -> bool:
    """Write checkpoint ``step`` under ``directory`` (keeps the last
    :data:`MAX_TO_KEEP`).  ``params`` is the model's state dict,
    ``opt_state`` the optimizer's.  Returns False, writing nothing, when
    ``step`` is not above the latest saved step, as orbax does."""
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
                  step: Optional[int] = None
                  ) -> Tuple[int, dict, dict]:
    """Restore ``(step, params, opt_state)`` (the latest step unless
    ``step`` is given), tensors on the CPU.

    ``params_like`` is a state dict of the model to load into (e.g. a
    fresh one): the saved params must have its keys, shapes and dtypes,
    else this raises ``ValueError`` (orbax raises on a shape mismatch
    too).  Load ``opt_state`` with :func:`load_optimizer_state`."""
    directory = os.path.abspath(directory)
    steps = _steps(directory)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        step = steps[-1]
    elif step not in steps:
        raise FileNotFoundError(f"no checkpoint of step {step} under {directory}")
    path = os.path.join(directory, str(step), STATE_FILE)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} checkpoint")
    params = blob["params"]
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
    return step, params, blob["opt_state"]


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
