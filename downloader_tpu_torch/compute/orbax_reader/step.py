"""One orbax step of the JAX package's checkpoints, read without orbax:
the counterpart of ``StandardRestore`` as
``downloader_tpu/compute/checkpoint.py:56-92`` restores a step.

A step directory ``<dir>/<step>/`` holds ``_CHECKPOINT_METADATA`` (JSON)
and one item directory each for ``params`` and ``opt_state``.  An item
holds ``_METADATA`` (JSON: each leaf's tree path and value type, and
whether the item is stored in OCDBT and zarr v2) and the OCDBT store
whose zarr arrays are named by the tree path joined with ``.``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

from .ocdbt import OcdbtStore
from .zarr2 import read_array

CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
ITEM_METADATA = "_METADATA"
ITEMS = ("params", "opt_state")


def _json(path: str) -> Any:
    try:
        with open(path, "rb") as fh:
            return json.loads(fh.read())
    except OSError as err:
        raise ValueError(f"{path}: cannot read ({err.strerror})") from err
    except json.JSONDecodeError as err:
        raise ValueError(f"{path}: not JSON ({err})") from err


def _read_item(item_dir: str) -> Dict[str, Any]:
    """One item of a step as nested dicts of numpy arrays, keyed as the
    saved tree is (a sequence's index as its string, ``"0"``); a leaf
    orbax skipped (optax's ``EmptyState``) is ``None``."""
    meta_path = os.path.join(item_dir, ITEM_METADATA)
    meta = _json(meta_path)
    if not isinstance(meta, dict) or not isinstance(meta.get("tree_metadata"), dict):
        raise ValueError(f"{meta_path}: holds no tree_metadata")
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{meta_path}: only OCDBT items of zarr v2 arrays are read")
    store = OcdbtStore(item_dir)
    tree: Dict[str, Any] = {}
    for path, leaf in meta["tree_metadata"].items():
        try:
            keys = [str(k["key"]) for k in leaf["key_metadata"]]
            value_meta = leaf["value_metadata"]
        except (KeyError, TypeError) as err:
            raise ValueError(f"{meta_path}: malformed entry {path}") from err
        if not keys:
            raise ValueError(f"{meta_path}: entry {path} has an empty tree path")
        if value_meta.get("skip_deserialize") or value_meta.get("value_type") == "None":
            value = None
        elif value_meta.get("value_type") in ("jax.Array", "np.ndarray"):
            value = read_array(store, ".".join(keys))
        else:
            raise ValueError(f"{meta_path}: value type {value_meta.get('value_type')!r} "
                             f"of {path} is not supported")
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
            if not isinstance(node, dict):
                raise ValueError(f"{meta_path}: {path} overlaps another leaf")
        node[keys[-1]] = value
    return tree


def read_step(step_dir: str) -> Dict[str, Dict[str, Any]]:
    """``{"params": tree, "opt_state": tree}`` of the orbax step at
    ``step_dir``; raises ``ValueError`` naming the file that is missing or
    cannot be read."""
    meta = _json(os.path.join(step_dir, CHECKPOINT_METADATA))
    if not isinstance(meta, dict):
        raise ValueError(f"{os.path.join(step_dir, CHECKPOINT_METADATA)}: not a JSON object")
    return {item: _read_item(os.path.join(step_dir, item)) for item in ITEMS}
