"""Vocos backbone (counterpart of ``speechflow_tpu/models/vocoder/backbones.py``):
embedding conv (k=7) -> LayerNorm (+ a projected speaker embedding when
``cond_dim`` is set) -> N ConvNeXt blocks -> LayerNorm, channels-last; and
``DummyBackbone``, the identity, for heads that take the features directly."""

from __future__ import annotations

import typing as tp

import torch
import torch.nn as nn

from speechflow_torch.models.layers import Conv1d, flax_init_, layer_norm
from speechflow_torch.models.tts.common import gelu
from speechflow_torch.ops.signal import depthwise_conv1d

__all__ = ["ConvNeXtBlock", "VocosBackbone", "DummyBackbone"]


class ConvNeXtBlock(nn.Module):
    """depthwise k=7 conv -> LayerNorm -> pointwise MLP (tanh GELU) ->
    per-channel residual scale."""

    def __init__(self, dim: int, mlp_ratio: int = 3, kernel_size: int = 7,
                 layer_scale: float = 1e-6):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, kernel_size, groups=dim)
        self.norm = layer_norm(dim)
        self.pw1 = nn.Linear(dim, mlp_ratio * dim)
        self.pw2 = nn.Linear(mlp_ratio * dim, dim)
        self.gamma = nn.Parameter(layer_scale * torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = depthwise_conv1d(x, self.dwconv.weight, self.dwconv.bias)
        h = self.pw2(gelu(self.pw1(self.norm(h))))
        return x + self.gamma * h


class VocosBackbone(nn.Module):
    def __init__(self, dim_in: int = 100, dim: int = 512, n_layers: int = 8,
                 mlp_ratio: int = 3, kernel_size: int = 7,
                 cond_dim: tp.Optional[int] = None):
        super().__init__()
        self.embed = Conv1d(dim_in, dim, 7)
        self.norm_in = layer_norm(dim)
        self.blocks = nn.ModuleList(ConvNeXtBlock(dim, mlp_ratio, kernel_size)
                                    for _ in range(n_layers))
        self.norm_out = layer_norm(dim)
        self.cond_proj = nn.Linear(cond_dim, dim) if cond_dim is not None else None
        self.dim = dim
        flax_init_(self)  # the blocks' gamma keeps layer_scale, as in JAX

    def forward(self, x: torch.Tensor, cond: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, dim_in) [, cond (B, cond_dim)] -> (B, T, dim)."""
        x = self.norm_in(self.embed(x))
        if self.cond_proj is not None and cond is not None:
            x = x + self.cond_proj(cond)[:, None, :]
        for blk in self.blocks:
            x = blk(x)
        return self.norm_out(x)


class DummyBackbone(nn.Module):
    """The identity: the head consumes the features as they come."""

    def __init__(self, dim_in: int = 100):
        super().__init__()
        self.dim = dim_in

    def forward(self, x: torch.Tensor, cond: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        return x
