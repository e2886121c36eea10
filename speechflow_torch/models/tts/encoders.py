"""Transformer encoders (counterpart of ``speechflow_tpu/models/tts/encoders.py``;
the slice needs ``TransformerEncoder`` and ``DiTEncoder``)."""

from __future__ import annotations

import typing as tp

import torch
import torch.nn as nn

from speechflow_torch.models.tts.common import DiTBlock, TransformerBlock
from speechflow_torch.utils.masks import apply_mask, sequence_mask

__all__ = ["TransformerEncoder", "DiTEncoder", "TTS_ENCODERS"]


class TransformerEncoder(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dim: int = 256, n_layers: int = 4,
                 n_heads: int = 4, **kw):
        super().__init__()
        self.pre = nn.Linear(dim_in, dim) if dim_in != dim else None
        self.blocks = nn.ModuleList(TransformerBlock(dim, n_heads) for _ in range(n_layers))
        self.post = nn.Linear(dim, dim_out) if dim != dim_out else None
        self.dim_out = dim_out

    def forward(self, x: torch.Tensor, lengths: tp.Optional[torch.Tensor] = None,
                cond: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.pre is not None:
            x = self.pre(x)
        mask = sequence_mask(lengths, x.shape[1]) if lengths is not None else None
        for blk in self.blocks:
            x = blk(x, mask)
        if self.post is not None:
            x = self.post(x)
        return apply_mask(x, mask) if mask is not None else x


class DiTEncoder(nn.Module):
    """AdaNorm-conditioned transformer (the CFM estimator's backbone)."""

    def __init__(self, dim_in: int, dim_out: int, dim: int = 256, n_layers: int = 4,
                 n_heads: int = 4, cond_dim: int = 256, **kw):
        super().__init__()
        self.pre = nn.Linear(dim_in, dim) if dim_in != dim else None
        self.blocks = nn.ModuleList(DiTBlock(dim, cond_dim, n_heads) for _ in range(n_layers))
        self.post = nn.Linear(dim, dim_out) if dim != dim_out else None
        self.dim_out = dim_out
        self.cond_dim = cond_dim

    def forward(self, x: torch.Tensor, lengths: tp.Optional[torch.Tensor] = None,
                cond: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.pre is not None:
            x = self.pre(x)
        if cond is None:
            cond = x.new_zeros(x.shape[0], self.cond_dim)
        mask = sequence_mask(lengths, x.shape[1]) if lengths is not None else None
        for blk in self.blocks:
            x = blk(x, cond, mask)
        if self.post is not None:
            x = self.post(x)
        return apply_mask(x, mask) if mask is not None else x


TTS_ENCODERS: tp.Dict[str, type] = {
    "transformer": TransformerEncoder,
    "dit": DiTEncoder,
}
