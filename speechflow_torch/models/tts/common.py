"""Acoustic-model building blocks (counterpart of
``speechflow_tpu/models/tts/common.py``), inference only: channels-last,
masked, dropout-free (the JAX blocks' dropout is the identity at inference).
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.models.layers import Conv1d, MultiHeadAttention, layer_norm

__all__ = ["sinusoidal_embedding", "rope_rotate", "gelu", "ConvBlock", "ConvStack",
           "AdaLayerNorm", "FiLM", "ConditionalLayer", "TransformerBlock", "DiTBlock"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``nnx.gelu``: the tanh approximation (torch's default is erf)."""
    return F.gelu(x, approximate="tanh")


def _freqs(half: int, max_period: float, device) -> torch.Tensor:
    return torch.exp(-math.log(max_period)
                     * torch.arange(half, dtype=torch.float32, device=device) / half)


def sinusoidal_embedding(positions: torch.Tensor, dim: int,
                         max_period: float = 10000.0) -> torch.Tensor:
    """(...,) -> (..., dim) f32 sin/cos embedding (timesteps, positions)."""
    args = positions[..., None].float() * _freqs(dim // 2, max_period, positions.device)
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def rope_rotate(x: torch.Tensor, max_period: float = 10000.0) -> torch.Tensor:
    """Half-split rotary embedding over (..., T, D) at positions 0..T-1,
    computed in f32 and returned in x's dtype."""
    t, d = x.shape[-2], x.shape[-1]
    half = d // 2
    pos = torch.arange(t, dtype=torch.float32, device=x.device)
    angles = pos[:, None] * _freqs(half, max_period, x.device)[None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:2 * half]
    parts = [x1 * cos - x2 * sin, x1 * sin + x2 * cos]
    if d % 2:
        parts.append(xf[..., -1:])
    return torch.cat(parts, dim=-1).to(x.dtype)


class ConvBlock(nn.Module):
    """SAME conv -> LayerNorm -> ReLU (the activation every stack of the slice uses)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int = 5):
        super().__init__()
        self.conv = Conv1d(dim_in, dim_out, kernel_size)
        self.norm = layer_norm(dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(self.conv(x)))


class ConvStack(nn.Module):
    def __init__(self, dim_in: int, dim: int, dim_out: int, n_layers: int = 3,
                 kernel_size: int = 5):
        super().__init__()
        dims = [dim_in] + [dim] * (n_layers - 1) + [dim_out]
        self.blocks = nn.ModuleList(
            ConvBlock(dims[i], dims[i + 1], kernel_size) for i in range(n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


def _modulation(proj: nn.Linear, cond: torch.Tensor, ndim: int):
    scale, shift = proj(cond).chunk(2, dim=-1)
    while scale.ndim < ndim:
        scale, shift = scale[:, None], shift[:, None]
    return scale, shift


class AdaLayerNorm(nn.Module):
    """LayerNorm (no affine) with condition-predicted scale and shift."""

    def __init__(self, dim: int, cond_dim: int):
        super().__init__()
        self.norm = layer_norm(dim, affine=False)
        self.proj = nn.Linear(cond_dim, 2 * dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        scale, shift = _modulation(self.proj, cond, x.ndim)
        return self.norm(x) * (1.0 + scale) + shift


class FiLM(nn.Module):
    def __init__(self, dim: int, cond_dim: int):
        super().__init__()
        self.proj = nn.Linear(cond_dim, 2 * dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        scale, shift = _modulation(self.proj, cond, x.ndim)
        return x * (1.0 + scale) + shift


class ConditionalLayer(nn.Module):
    """cat / add / adanorm / film conditioning on a global (B, C) or
    per-position (B, T, C) condition."""

    def __init__(self, method: str, dim: int, cond_dim: int):
        super().__init__()
        self.method = method
        if method == "cat":
            self.proj = nn.Linear(dim + cond_dim, dim)
        elif method == "add":
            self.proj = nn.Linear(cond_dim, dim)
        elif method == "adanorm":
            self.layer = AdaLayerNorm(dim, cond_dim)
        elif method == "film":
            self.layer = FiLM(dim, cond_dim)
        else:
            raise ValueError(f"unknown condition method: {method}")

    def forward(self, x: torch.Tensor, cond: tp.Optional[torch.Tensor]) -> torch.Tensor:
        if cond is None:
            return x
        cond_t = cond[:, None, :].expand(x.shape[0], x.shape[1], cond.shape[-1]) \
            if cond.ndim == 2 else cond
        if self.method == "cat":
            return self.proj(torch.cat([x, cond_t], dim=-1))
        if self.method == "add":
            return x + self.proj(cond_t)
        return self.layer(x, cond)


class TransformerBlock(nn.Module):
    """Pre-LN MHA + FFN with RoPE on the normed hidden state before q/k/v."""

    def __init__(self, dim: int, n_heads: int = 4, ffn_mult: int = 4,
                 use_rope: bool = True):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = MultiHeadAttention(dim, n_heads)
        self.norm2 = layer_norm(dim)
        self.ffn1 = nn.Linear(dim, ffn_mult * dim)
        self.ffn2 = nn.Linear(ffn_mult * dim, dim)
        self.use_rope = use_rope

    def forward(self, x: torch.Tensor,
                valid: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.norm1(x)
        if self.use_rope:
            h = rope_rotate(h)
        x = x + self.attn(h, valid)
        return x + self.ffn2(gelu(self.ffn1(self.norm2(x))))


class DiTBlock(nn.Module):
    """AdaNorm-modulated attention + MLP with gated residuals."""

    def __init__(self, dim: int, cond_dim: int, n_heads: int = 4, ffn_mult: int = 4):
        super().__init__()
        self.mod = nn.Linear(cond_dim, 6 * dim)
        self.norm1 = layer_norm(dim, affine=False)
        self.attn = MultiHeadAttention(dim, n_heads)
        self.norm2 = layer_norm(dim, affine=False)
        self.ffn1 = nn.Linear(dim, ffn_mult * dim)
        self.ffn2 = nn.Linear(ffn_mult * dim, dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                valid: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        sh1, sc1, g1, sh2, sc2, g2 = self.mod(cond)[:, None, :].chunk(6, dim=-1)
        h = rope_rotate(self.norm1(x) * (1 + sc1) + sh1)
        x = x + g1 * self.attn(h, valid)
        h = self.norm2(x) * (1 + sc2) + sh2
        return x + g2 * self.ffn2(gelu(self.ffn1(h)))
