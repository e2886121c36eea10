"""Vocos generator (counterpart of ``speechflow_tpu/models/vocoder/model.py``):
features -> backbone -> head. The slice ports the ``audio`` feature
extractor, the ``vocos`` backbone and the ``snake_upsample`` head; other
choices raise."""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn as nn

from speechflow_torch.models.vocoder.backbones import VocosBackbone
from speechflow_torch.models.vocoder.feature_extractors import AudioFeatures
from speechflow_torch.models.vocoder.heads import SnakeUpsampleHead
from speechflow_torch.training.base_model import BaseModelParams

__all__ = ["Vocos", "VocosParams"]


@dataclasses.dataclass
class VocosParams(BaseModelParams):
    sample_rate: int = 24000
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 100
    feature_extractor: str = "mel"
    input_feature: str = "mel"
    backbone: str = "vocos"
    head: str = "istft"
    dim: int = 512
    n_layers: int = 8
    mlp_ratio: int = 3
    cond_dim: tp.Optional[int] = None
    upsample_rates: tp.Tuple[int, ...] = (8, 8, 2, 2)
    upsample_channels: int = 256
    resblock_kernel_sizes: tp.Tuple[int, ...] = (3,)
    snake_taps: int = 12


class Vocos(nn.Module):
    def __init__(self, params: VocosParams):
        super().__init__()
        p = self.params = params
        if p.feature_extractor != "audio":
            raise NotImplementedError(
                f"feature_extractor={p.feature_extractor!r} is not ported yet")
        if p.backbone != "vocos":
            raise NotImplementedError(f"backbone={p.backbone!r} is not ported yet")
        if p.head != "snake_upsample":
            raise NotImplementedError(f"head={p.head!r} is not ported yet")
        if p.cond_dim is not None:
            raise NotImplementedError("speaker conditioning (cond_dim) is not ported yet")
        self.feature_extractor = AudioFeatures(p.input_feature, p.n_mels)
        self.backbone = VocosBackbone(self.feature_extractor.dim, p.dim, p.n_layers,
                                      p.mlp_ratio)
        self.head = SnakeUpsampleHead(self.backbone.dim, p.upsample_rates,
                                      channels=p.upsample_channels,
                                      resblock_kernel_sizes=p.resblock_kernel_sizes,
                                      taps=p.snake_taps)

    def forward(self, inputs: tp.Mapping[str, torch.Tensor]) -> torch.Tensor:
        return self.from_features(self.feature_extractor(inputs))

    def from_features(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, T, feat_dim) -> (B, (T-1)·hop) waveform: T feature frames give
        exactly (T-1)·hop samples, the JAX package's uniform contract."""
        wav = self.head(self.backbone(feats))
        return wav[..., : (feats.shape[1] - 1) * self.params.hop_length]
