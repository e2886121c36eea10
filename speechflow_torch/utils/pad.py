"""Host-side padding for collate functions (counterpart of
``speechflow_tpu/utils/pad.py``): pad 1-D/2-D arrays along axis 0 to a common
length, optionally rounded up to a multiple, and stack them. Numpy only; the
JAX package's native packer gives the same arrays."""

from __future__ import annotations

import typing as tp

import numpy as np

__all__ = ["pad_1d", "pad_2d", "stack_and_pad", "round_up"]


def round_up(n: int, multiple: tp.Optional[int]) -> int:
    if not multiple or multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


def pad_1d(x: np.ndarray, target_len: int, pad_value: float = 0.0) -> np.ndarray:
    if len(x) >= target_len:
        return x[:target_len]
    return np.pad(x, (0, target_len - len(x)), constant_values=pad_value)


def pad_2d(x: np.ndarray, target_len: int, pad_value: float = 0.0) -> np.ndarray:
    """Pad along axis 0 of a (T, D) array."""
    if x.shape[0] >= target_len:
        return x[:target_len]
    pad = [(0, target_len - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=pad_value)


def stack_and_pad(
    arrays: tp.Sequence[np.ndarray],
    pad_value: float = 0.0,
    multiple: tp.Optional[int] = None,
    target_len: tp.Optional[int] = None,
) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length arrays into (B, T, ...) + lengths (B,); T is
    ``target_len`` if given (longer arrays are cut), else the longest length
    rounded up to ``multiple``."""
    lengths = np.asarray([a.shape[0] for a in arrays], dtype=np.int32)
    tmax = target_len if target_len is not None else round_up(int(lengths.max()), multiple)
    fn = pad_1d if arrays[0].ndim == 1 else pad_2d
    return np.stack([fn(a, tmax, pad_value) for a in arrays]), lengths
