"""Normalizing-flow layers of the Glow aligner's decoder (counterpart of
``speechflow_tpu/models/aligner/flows.py``): invertible transforms over
(B, T, C) mel frames under a frame mask, each returning its log-determinant
for the MLE loss; ``reverse=True`` runs the inverse with the same weights.

- ``ActNorm``: a per-channel affine with a log-scale, both zero at the start;
- ``Inv1x1Conv``: channel mixing in groups of ``n_split`` by an n x n matrix;
  every one starts from the same orthogonal Q, the JAX package's
  ``np.linalg.qr`` of ``np.random.default_rng(0)``'s normals, and its inverse
  and log-determinant are taken in float32;
- ``AffineCoupling``: half the channels give the other half's scale (tanh of a
  log-scale) and shift through gated dilated convs, optionally conditioned; its
  output conv starts at zero, so a fresh coupling is the identity;
- ``FlowSpecDecoder``: the frames squeezed by two (pairs interleaved by a
  reshape), then K x (ActNorm -> Inv1x1Conv -> AffineCoupling).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn as nn

from speechflow_torch.models.layers import Conv1d, flax_init_
from speechflow_torch.utils.masks import sequence_mask

__all__ = ["ActNorm", "Inv1x1Conv", "AffineCoupling", "FlowSpecDecoder"]

Out = tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]


class ActNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.logs = nn.Parameter(torch.zeros(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, reverse: bool = False) -> Out:
        if reverse:
            return (x - self.bias) * torch.exp(-self.logs) * mask, None
        y = (x * torch.exp(self.logs) + self.bias) * mask
        return y, self.logs.sum() * mask[..., 0].sum(dim=-1)


def _initial_rotation(n: int) -> np.ndarray:
    q, _ = np.linalg.qr(np.random.default_rng(0).normal(size=(n, n)))
    return q.astype(np.float32)


class Inv1x1Conv(nn.Module):
    """x reshaped to (B, T, C/n, n) and multiplied by an n x n matrix."""

    def __init__(self, channels: int, n_split: int = 4):
        super().__init__()
        if channels % n_split:
            raise ValueError(f"{channels} channels do not split into groups of {n_split}")
        self.n_split = n_split
        self.weight = nn.Parameter(torch.from_numpy(_initial_rotation(n_split)))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, reverse: bool = False) -> Out:
        b, t, c = x.shape
        n = self.n_split
        w = self.weight.float()
        xg = x.reshape(b, t, c // n, n)
        if reverse:
            y = torch.matmul(xg, torch.linalg.inv(w).to(x.dtype)).reshape(b, t, c)
            return y * mask, None
        y = torch.matmul(xg, w.to(x.dtype)).reshape(b, t, c) * mask
        logabsdet = torch.linalg.slogdet(w)[1]
        return y, logabsdet * (c // n) * mask[..., 0].sum(dim=-1)


class AffineCoupling(nn.Module):
    zero_init = ("post",)

    def __init__(self, channels: int, hidden: int = 192, n_layers: int = 3,
                 kernel_size: int = 5, cond_dim: tp.Optional[int] = None):
        super().__init__()
        half = self.half = channels // 2
        self.pre = Conv1d(half, hidden, 1)
        self.convs = nn.ModuleList(Conv1d(hidden, 2 * hidden, kernel_size, dilation=2 ** i)
                                   for i in range(n_layers))
        self.cond_proj = nn.Linear(cond_dim, 2 * hidden * n_layers) if cond_dim else None
        self.post = Conv1d(hidden, channels, 1)
        self.n_layers = n_layers
        self.hidden = hidden

    def _net(self, xa: torch.Tensor, mask: torch.Tensor, cond: tp.Optional[torch.Tensor]):
        h = self.pre(xa) * mask
        cond_parts = None
        if self.cond_proj is not None and cond is not None:
            cond_parts = self.cond_proj(cond)[:, None, :].chunk(self.n_layers, dim=-1)
        for i, conv in enumerate(self.convs):
            u = conv(h)
            if cond_parts is not None:
                u = u + cond_parts[i]
            a, g = u.chunk(2, dim=-1)
            h = (h + torch.tanh(a) * torch.sigmoid(g)) * mask
        out = self.post(h)
        return torch.tanh(out[..., : self.half]), out[..., self.half:]

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                cond: tp.Optional[torch.Tensor] = None, reverse: bool = False) -> Out:
        xa, xb = x[..., : self.half], x[..., self.half:]
        logs, shift = self._net(xa, mask, cond)
        if reverse:
            return torch.cat([xa, (xb - shift) * torch.exp(-logs) * mask], dim=-1), None
        yb = (xb * torch.exp(logs) + shift) * mask
        return torch.cat([xa, yb], dim=-1), (logs * mask).sum(dim=(1, 2))


class FlowSpecDecoder(nn.Module):
    def __init__(self, n_mels: int, n_flows: int = 6, hidden: int = 192, n_split: int = 4,
                 cond_dim: tp.Optional[int] = None):
        super().__init__()
        c = n_mels * 2  # after the time squeeze
        self.n_mels = n_mels
        self.actnorms = nn.ModuleList(ActNorm(c) for _ in range(n_flows))
        self.invconvs = nn.ModuleList(Inv1x1Conv(c, n_split) for _ in range(n_flows))
        self.couplings = nn.ModuleList(AffineCoupling(c, hidden, cond_dim=cond_dim)
                                       for _ in range(n_flows))
        flax_init_(self)

    @staticmethod
    def _squeeze(x: torch.Tensor, lengths: torch.Tensor):
        b, t, c = x.shape
        t2 = t // 2
        return x[:, : t2 * 2].reshape(b, t2, 2 * c), lengths // 2

    @staticmethod
    def _unsqueeze(x: torch.Tensor) -> torch.Tensor:
        b, t2, c2 = x.shape
        return x.reshape(b, t2 * 2, c2 // 2)

    def forward(self, mel: torch.Tensor, mel_lengths: torch.Tensor,
                cond: tp.Optional[torch.Tensor] = None, reverse: bool = False) -> Out:
        """(B, T, n_mels) -> (z (B, T//2·2, n_mels), log-determinant (B,)), or the
        inverse (no log-determinant)."""
        x, lens2 = self._squeeze(mel, mel_lengths)
        mask = sequence_mask(lens2, x.shape[1])[..., None].to(x.dtype)
        stages = list(zip(self.actnorms, self.invconvs, self.couplings))
        if reverse:
            for an, ic, cp in reversed(stages):
                x, _ = cp(x, mask, cond, reverse=True)
                x, _ = ic(x, mask, reverse=True)
                x, _ = an(x, mask, reverse=True)
            return self._unsqueeze(x), None
        total = x.new_zeros(x.shape[0])
        for an, ic, cp in stages:
            x, ld1 = an(x, mask)
            x, ld2 = ic(x, mask)
            x, ld3 = cp(x, mask, cond)
            total = total + ld1 + ld2 + ld3
        return self._unsqueeze(x), total
