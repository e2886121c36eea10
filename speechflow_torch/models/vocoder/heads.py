"""BigVGAN-class upsampling head (counterpart of
``speechflow_tpu/models/vocoder/heads.py``; the slice needs
``AntiAliasedSnake``, ``ResBlock`` and ``SnakeUpsampleHead``).

Every activation goes through the hand-written anti-alias kernel
(``speechflow_torch.ops.anti_alias``) on the GPU. Within a
multi-receptive-field group every branch's first activation sees the same
input, so the interpolation FIR (``aa_upsample_fir``) runs once per group
and each branch applies only its snake and decimation
(``aa_snake_downsample``) — exact, as in the JAX head.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn as nn

from speechflow_torch.models.layers import Conv1d, ConvTranspose1d
from speechflow_torch.ops.anti_alias import (
    aa_snake_downsample,
    aa_upsample_fir,
    anti_alias_snake,
)

__all__ = ["AntiAliasedSnake", "ResBlock", "SnakeUpsampleHead"]


class AntiAliasedSnake(nn.Module):
    """upsample 2x (FIR) -> snake-beta -> FIR -> downsample 2x."""

    def __init__(self, channels: int, taps: int = 12):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.taps = taps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return anti_alias_snake(x, self.alpha, self.beta, self.taps)

    def from_shared(self, y_even: torch.Tensor, y_odd: torch.Tensor) -> torch.Tensor:
        """Snake + decimation on a precomputed (shared) stage-1 pair."""
        return aa_snake_downsample(y_even, y_odd, self.alpha, self.beta, self.taps)


class ResBlock(nn.Module):
    """AMP residual block: dilated SAME convs after anti-aliased snakes."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: tp.Sequence[int] = (1, 3, 5), taps: int = 12):
        super().__init__()
        self.convs = nn.ModuleList(Conv1d(channels, channels, kernel_size, dilation=d)
                                   for d in dilations)
        self.acts = nn.ModuleList(AntiAliasedSnake(channels, taps) for _ in dilations)

    def forward(self, x: torch.Tensor, shared_stage1=None) -> torch.Tensor:
        for i, (act, conv) in enumerate(zip(self.acts, self.convs)):
            a = act.from_shared(*shared_stage1) if i == 0 and shared_stage1 is not None \
                else act(x)
            x = x + conv(a)
        return x


class SnakeUpsampleHead(nn.Module):
    """Stacked transposed-conv upsampling, each stage followed by the mean of
    parallel AMP resblocks (kernels ``resblock_kernel_sizes``)."""

    def __init__(self, dim: int = 512, upsample_rates: tp.Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: tp.Optional[tp.Sequence[int]] = None,
                 channels: int = 256, resblock_kernel_sizes: tp.Sequence[int] = (3,),
                 taps: int = 12):
        super().__init__()
        upsample_kernel_sizes = upsample_kernel_sizes or [2 * r for r in upsample_rates]
        self.pre = Conv1d(dim, channels, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        self.taps = taps
        ch = channels
        for r, k in zip(upsample_rates, upsample_kernel_sizes):
            self.ups.append(ConvTranspose1d(ch, ch // 2, k, r))
            ch //= 2
            self.resblocks.append(nn.ModuleList(ResBlock(ch, ks, taps=taps)
                                                for ks in resblock_kernel_sizes))
        self.post_act = AntiAliasedSnake(ch, taps)
        self.post = Conv1d(ch, 1, 7)
        self.total_upsample = int(np.prod(upsample_rates))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, dim) -> (B, T·prod(rates)) waveform."""
        x = self.pre(x)
        for up, group in zip(self.ups, self.resblocks):
            x = up(x)
            s1 = aa_upsample_fir(x, self.taps) if len(group) > 1 else None
            acc = group[0](x, shared_stage1=s1)
            for res in group[1:]:
                acc = acc + res(x, shared_stage1=s1)
            x = acc / len(group)
        x = self.post(self.post_act(x))
        return torch.tanh(x)[..., 0]
