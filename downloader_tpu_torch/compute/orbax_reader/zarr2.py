"""zarr v2 arrays over an :class:`~.ocdbt.OcdbtStore`, as orbax writes
them: ``<name>/.zarray`` (JSON) and one key per chunk, ``<name>/<i>.<j>...``
(``<name>/0`` for a scalar), each chunk C-ordered and zstd-compressed or
raw.  A chunk the store lacks holds the fill value (orbax writes with
``store_array_data_equal_to_fill_value``, so it is rare); chunks smaller
than the array, as a mesh-sharded save writes them, are assembled into
the whole array.
"""

from __future__ import annotations

import itertools
import json
import math
from typing import Any, List

import numpy as np

from . import zstd
from .ocdbt import OcdbtStore

_FLOAT_FILLS = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}


def _dtype(spec: Any) -> np.dtype:
    """The array's dtype; bfloat16 (which numpy lacks) is read as its bit
    pattern, ``uint16``, and widened by :func:`read_array`."""
    if spec == "bfloat16":
        return np.dtype("<u2")
    try:
        dtype = np.dtype(spec)
    except TypeError as err:
        raise ValueError(f"zarr dtype {spec!r} is not supported") from err
    if dtype.kind not in "biuf" or dtype.fields is not None:
        raise ValueError(f"zarr dtype {spec!r} is not supported")
    return dtype


def read_array(store: OcdbtStore, name: str) -> np.ndarray:
    """The array ``name`` of ``store``, whole, in native byte order;
    bfloat16 comes back as the float32 of the same value."""
    where = f"{store.root} [{name}]"
    try:
        meta = json.loads(store.read(f"{name}/.zarray"))
    except KeyError:
        raise ValueError(f"{where}: no zarr array of that name") from None
    except json.JSONDecodeError as err:
        raise ValueError(f"{where}: .zarray is not JSON ({err})") from err
    if not isinstance(meta, dict) or meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: not a zarr v2 array")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{where}: only C-ordered arrays without filters are read")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{where}: zarr compressor {compressor.get('id')!r} "
                         "is not supported (zstd or none)")
    separator = meta.get("dimension_separator", ".")
    if separator != ".":
        raise ValueError(f"{where}: zarr dimension separator {separator!r}")
    dtype = _dtype(meta.get("dtype"))
    shape: List[int] = list(meta.get("shape", []))
    chunks: List[int] = list(meta.get("chunks", []))
    if len(shape) != len(chunks) or any(c < 1 for c in chunks) or any(s < 0 for s in shape):
        raise ValueError(f"{where}: chunks {chunks} do not fit shape {shape}")
    fill = meta.get("fill_value")
    fill = 0 if fill is None else _FLOAT_FILLS.get(fill, fill)
    if meta.get("dtype") == "bfloat16":
        bits = int(np.array(fill, np.float32).view(np.uint32))
        fill = 0x7FC0 if np.isnan(fill) else (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    out = np.full(shape, fill, dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for index in itertools.product(*grid):
        key = f"{name}/" + (".".join(map(str, index)) if index else "0")
        if key not in store:
            continue
        raw = store.read(key)
        if compressor is not None:
            try:
                raw = zstd.decompress(raw)
            except ValueError as err:
                raise ValueError(f"{where}: chunk {key}: {err}") from err
        if len(raw) != chunk_bytes:
            raise ValueError(f"{where}: chunk {key} holds {len(raw)} bytes, "
                             f"not {chunk_bytes}")
        chunk = np.frombuffer(raw, dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if meta.get("dtype") == "bfloat16":
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out.astype(dtype.newbyteorder("="), copy=False)
