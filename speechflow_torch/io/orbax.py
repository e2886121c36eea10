"""Orbax checkpoints of the JAX package, read without orbax or tensorstore.

``speechflow_tpu.training.ExperimentSaver`` saves its state tree with orbax's
``PyTreeCheckpointer``: an OCDBT store (``io.ocdbt``) of zarr v2 arrays, one
per leaf, under the leaf's ``.``-joined key path, and ``_METADATA``, a JSON
file whose ``tree_metadata`` lists every leaf's key path with each key's type
(1 a sequence index, 2 a dict key) and value type. ``read_tree`` rebuilds the
tree as orbax restores it: sequences come back as lists, dict keys as the
strings orbax stored (an nnx list index is the key ``"0"``), array leaves as
numpy arrays of their stored dtype, except bfloat16, which numpy lacks and
which comes back as a ``torch.bfloat16`` tensor (same bits).

A zarr v2 array (``<name>/.zarray``) is decoded for dtypes ``<f4``, ``<f8``,
``<i4``, ``<i8``, unsigned and bool (``|b1``) and ``bfloat16``; order C or F;
chunks compressed with zstd or stored raw; several chunks, whose keys are the
chunk indices joined by the ``dimension_separator``; missing chunks, which read
as the fill value (zero where it is null); 0-d arrays (chunk key ``0``). Zarr
v3 (``use_zarr3: true``), filters and other compressors raise by name.
"""

from __future__ import annotations

import json
import typing as tp
from pathlib import Path

import numpy as np

from speechflow_torch.io import zstd
from speechflow_torch.io.ocdbt import OcdbtStore

__all__ = ["is_orbax_checkpoint", "read_tree", "read_zarr", "top_keys"]

_SEQUENCE, _DICT = 1, 2
_ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")
_EMPTY = {"None": None, "Dict": dict, "List": list}


def is_orbax_checkpoint(path: tp.Union[str, Path]) -> bool:
    return (Path(path) / "_METADATA").is_file()


def _dtype(name: str) -> tp.Union[np.dtype, str]:
    if name == "bfloat16":
        return name
    dt = np.dtype(name)
    if dt.kind not in "biuf":
        raise ValueError(f"zarr dtype {name!r} is not supported")
    return dt


def _fill(value) -> float:
    if value is None:
        return 0
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        return float(value.replace("Infinity", "inf"))
    return value


def read_zarr(store, name: str):
    """The zarr v2 array ``name`` of ``store`` (an object with ``read``)."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}, expected 2")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: zarr compressor {comp.get('id')!r} is not supported "
                         "(zstd or none)")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"{name}: zarr order {order!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dt = _dtype(meta["dtype"])
    bf16 = dt == "bfloat16"
    store_dt = np.dtype("<u2") if bf16 else dt
    fill = _fill(meta.get("fill_value"))
    if bf16:  # the fill value's bits, as a bfloat16 is the top half of a float32
        fill = int(np.array(fill, np.float32).view(np.uint32) >> 16)
    out = np.full(shape, fill, store_dt)
    sep = meta.get("dimension_separator", ".")
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid) if shape else [()]:
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        try:
            raw = store.read(key)
        except KeyError:
            continue  # a chunk never written holds the fill value
        if comp is not None:
            raw = zstd.decompress(raw)
        n = int(np.prod(chunks)) if chunks else 1
        if len(raw) != n * store_dt.itemsize:
            raise ValueError(f"{key}: {len(raw)} bytes, a chunk of {chunks} "
                             f"{meta['dtype']} needs {n * store_dt.itemsize}")
        block = np.frombuffer(raw, store_dt).reshape(chunks, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    if bf16:
        import torch

        return torch.from_numpy(out.astype(np.int16, copy=False)).view(torch.bfloat16)
    return out.astype(store_dt.newbyteorder("="), copy=False)


def _insert(tree, keys: tp.Sequence[tp.Tuple[str, int]], value) -> tp.Any:
    """``tree`` with ``value`` at the key path (containers made on the way:
    a list where the next key is a sequence index, else a dict)."""
    key, kind = keys[0]
    if kind == _SEQUENCE:
        node = tree if isinstance(tree, list) else []
        i = int(key)
        node.extend([None] * (i + 1 - len(node)))
        node[i] = value if len(keys) == 1 else _insert(node[i], keys[1:], value)
        return node
    if kind != _DICT:
        raise ValueError(f"orbax key {key!r}: key_type {kind} is not supported")
    node = tree if isinstance(tree, dict) else {}
    node[key] = value if len(keys) == 1 else _insert(node.get(key), keys[1:], value)
    return node


def top_keys(path: tp.Union[str, Path]) -> tp.Set[str]:
    """The top-level keys of the tree of the orbax checkpoint ``path`` (from its
    ``_METADATA``, no array read)."""
    meta = json.loads((Path(path) / "_METADATA").read_text())
    return {entry["key_metadata"][0]["key"] for entry in meta["tree_metadata"].values()
            if entry["key_metadata"]}


def read_tree(path: tp.Union[str, Path]) -> tp.Any:
    """The state tree of the orbax checkpoint directory ``path``, as orbax's
    ``PyTreeCheckpointer().restore`` returns it."""
    path = Path(path)
    meta_file = path / "_METADATA"
    if not meta_file.is_file():
        raise FileNotFoundError(f"{path}: no _METADATA (not an orbax checkpoint)")
    meta = json.loads(meta_file.read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: written with use_zarr3: true; only zarr v2 "
                         "(use_zarr3: false) is read")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: written without OCDBT (use_ocdbt: false); only OCDBT "
                         "checkpoints are read")
    store = OcdbtStore(path)  # the merged store orbax writes at the top when it finishes
    tree: tp.Any = None
    entries = meta["tree_metadata"]
    for name, entry in entries.items():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        vtype = entry["value_metadata"]["value_type"]
        if vtype in _ARRAY_TYPES:
            value = read_zarr(store, ".".join(k for k, _ in keys))
            if vtype == "scalar":
                value = value.item()
        elif vtype in _EMPTY:
            value = _EMPTY[vtype]() if _EMPTY[vtype] else None
        else:
            raise ValueError(f"{path}: leaf {name} has value type {vtype!r}, which is not "
                             "read")
        tree = _insert(tree, keys, value)
    return {} if tree is None else tree
