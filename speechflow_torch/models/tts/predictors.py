"""Variance and duration predictors (counterpart of
``speechflow_tpu/models/tts/predictors.py``; the slice needs
``VariancePredictor`` and ``TokenLevelDP``)."""

from __future__ import annotations

import typing as tp

import torch
import torch.nn as nn

from speechflow_torch.models.tts.common import ConvStack
from speechflow_torch.utils.masks import apply_mask, sequence_mask

__all__ = ["VariancePredictor", "TokenLevelDP"]


class VariancePredictor(nn.Module):
    """Conv stack -> per-position scalar."""

    def __init__(self, dim_in: int, dim: int = 256, n_layers: int = 3,
                 kernel_size: int = 5):
        super().__init__()
        self.stack = ConvStack(dim_in, dim, dim, n_layers, kernel_size)
        self.out = nn.Linear(dim, 1)

    def forward(self, x: torch.Tensor,
                lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        v = self.out(self.stack(x))[..., 0]
        if lengths is not None:
            v = apply_mask(v, sequence_mask(lengths, v.shape[1]))
        return v


class TokenLevelDP(nn.Module):
    """Duration predictor in the log(1 + d) domain."""

    def __init__(self, dim_in: int, dim: int = 256, n_layers: int = 2,
                 kernel_size: int = 3):
        super().__init__()
        self.stack = ConvStack(dim_in, dim, dim, n_layers, kernel_size)
        self.out = nn.Linear(dim, 1)

    def forward(self, x: torch.Tensor,
                lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        v = self.out(self.stack(x))[..., 0]
        if lengths is not None:
            v = apply_mask(v, sequence_mask(lengths, v.shape[1]))
        return v

    @staticmethod
    def to_durations(log_d: torch.Tensor,
                     lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        d = torch.clamp(torch.expm1(log_d), min=0.0)
        if lengths is not None:
            d = apply_mask(d, sequence_mask(lengths, d.shape[1]))
        return d
