"""Speaker-embedding network (counterpart of
``speechflow_tpu/models/biometric/ecapa.py``): a TDNN trunk of SE-res blocks
and attentive statistics pooling over log-mel frames, giving L2-normalised
speaker embeddings.

As in JAX, the squeeze of each SE block averages over every frame, padded
ones included, so padding a waveform changes its embedding; only the
attentive pooling is masked (``-1e9`` logits past ``lengths``), and its
standard deviation is ``sqrt(max(Σx²w − mean², 1e-6))`` in the input's dtype.
The weights start from flax's initialisers (``flax_init_``).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.models.layers import Conv1d, flax_init_, layer_norm
from speechflow_torch.training.base_model import BaseModelParams
from speechflow_torch.utils.masks import sequence_mask

__all__ = ["ECAPAParams", "ECAPAEmbedder", "triplet_loss"]


@dataclasses.dataclass
class ECAPAParams(BaseModelParams):
    n_mels: int = 80
    channels: int = 256
    emb_dim: int = 192
    n_blocks: int = 3


class _SERes1D(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilation: int):
        super().__init__()
        self.conv1 = Conv1d(channels, channels, 1)
        self.conv2 = Conv1d(channels, channels, kernel_size, dilation=dilation)
        self.conv3 = Conv1d(channels, channels, 1)
        self.se1 = nn.Linear(channels, channels // 8)
        self.se2 = nn.Linear(channels // 8, channels)
        self.norm = layer_norm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv1(x))
        h = F.relu(self.conv2(h))
        h = self.conv3(h)
        s = h.mean(dim=1)  # squeeze over every frame, padded ones included
        s = torch.sigmoid(self.se2(F.relu(self.se1(s))))
        return self.norm(x + h * s[:, None, :])


class ECAPAEmbedder(nn.Module):
    def __init__(self, params: ECAPAParams):
        super().__init__()
        p = self.p = params
        self.pre = Conv1d(p.n_mels, p.channels, 5)
        self.blocks = nn.ModuleList(_SERes1D(p.channels, 3, 2 ** (i + 1))
                                    for i in range(p.n_blocks))
        self.cat_proj = Conv1d(p.channels * p.n_blocks, p.channels, 1)
        self.attn1 = Conv1d(p.channels, p.channels // 2, 1)
        self.attn2 = Conv1d(p.channels // 2, p.channels, 1)
        self.out = nn.Linear(2 * p.channels, p.emb_dim)
        flax_init_(self)

    def forward(self, mel: torch.Tensor,
                lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, n_mels) log-mel -> (B, emb_dim) L2-normalised embedding."""
        x = F.relu(self.pre(mel))
        feats = []
        for blk in self.blocks:
            x = blk(x)
            feats.append(x)
        x = F.relu(self.cat_proj(torch.cat(feats, dim=-1)))

        w = self.attn2(torch.tanh(self.attn1(x)))
        if lengths is not None:
            mask = sequence_mask(lengths, x.shape[1])[..., None]
            w = torch.where(mask, w, torch.full_like(w, -1e9))
        w = torch.softmax(w, dim=1)
        mean = (x * w).sum(dim=1)
        var = (x ** 2 * w).sum(dim=1) - mean ** 2
        std = torch.sqrt(torch.clamp(var, min=1e-6))
        emb = self.out(torch.cat([mean, std], dim=-1))
        return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-9)


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                 margin: float = 0.3) -> torch.Tensor:
    """Cosine triplet loss for speaker verification."""
    pos = (anchor * positive).sum(-1)
    neg = (anchor * negative).sum(-1)
    return torch.clamp(margin - pos + neg, min=0.0).mean()
