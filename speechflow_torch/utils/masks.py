"""Length masks (counterpart of ``speechflow_tpu/utils/masks.py``)."""

from __future__ import annotations

import torch

__all__ = ["sequence_mask", "apply_mask", "masked_mean", "lengths_from_mask"]


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, T) bool mask; True at valid positions."""
    pos = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def apply_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero out padded positions; mask is (B, T), x is (B, T, ...) or (B, T)."""
    while mask.ndim < x.ndim:
        mask = mask[..., None]
    return x * mask.to(x.dtype)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None,
                eps: float = 1e-9) -> torch.Tensor:
    """sum(x·mask) / (sum(mask) + eps) over ``axis`` (None: all), the mask given
    trailing axes to x's rank as the JAX ``masked_mean`` does: a mask narrower
    than x counts each of its positions once."""
    while mask.ndim < x.ndim:
        mask = mask[..., None]
    m = mask.to(x.dtype)
    return (x * m).sum(dim=axis) / (m.sum(dim=axis) + eps)


def lengths_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """The count of True (non-zero) entries along the last axis, int32."""
    return mask.to(torch.int32).sum(-1, dtype=torch.int32)
