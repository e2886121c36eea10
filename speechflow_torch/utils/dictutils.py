"""Nested-dict helpers (counterpart of ``speechflow_tpu/utils/dictutils.py``)."""

from __future__ import annotations

import typing as tp

__all__ = ["flatten_dict", "unflatten_dict", "deep_update"]


def flatten_dict(d: tp.Mapping, sep: str = ".", prefix: str = "") -> dict:
    """Nested dicts -> one dict of ``sep``-joined keys (an empty dict leaves no key)."""
    out = {}
    for k, v in d.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_dict(v, sep, key))
        else:
            out[key] = v
    return out


def unflatten_dict(d: tp.Mapping, sep: str = ".") -> dict:
    """The inverse of ``flatten_dict`` (keys as strings)."""
    out: dict = {}
    for k, v in d.items():
        node = out
        parts = str(k).split(sep)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def deep_update(base: dict, update: tp.Mapping) -> dict:
    """``base`` updated in place by ``update``, dicts merged key by key; returns it."""
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base
