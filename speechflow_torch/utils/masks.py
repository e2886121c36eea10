"""Length masks (counterpart of ``speechflow_tpu/utils/masks.py``)."""

from __future__ import annotations

import torch

__all__ = ["sequence_mask", "apply_mask"]


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, T) bool mask; True at valid positions."""
    pos = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def apply_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero out padded positions; mask is (B, T), x is (B, T, ...) or (B, T)."""
    while mask.ndim < x.ndim:
        mask = mask[..., None]
    return x * mask.to(x.dtype)
