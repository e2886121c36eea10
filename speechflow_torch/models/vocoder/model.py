"""Vocos generator (counterpart of ``speechflow_tpu/models/vocoder/model.py``):
features -> backbone -> head. Ported: the ``mel`` and ``audio`` feature
extractors, the ``vocos`` backbone (with ``cond_dim`` speaker conditioning),
the ``istft`` and ``snake_upsample`` heads, and ``fold_inference``. The
``codec`` and ``tts`` extractors, the ``dummy`` backbone and the NSF, IMDCT
and DAC heads raise ``NotImplementedError``."""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn as nn

from speechflow_torch.models.vocoder.backbones import VocosBackbone
from speechflow_torch.models.vocoder.feature_extractors import AudioFeatures, MelFeatures
from speechflow_torch.models.vocoder.folded_head import FoldedSnakeHead
from speechflow_torch.models.vocoder.heads import ISTFTHead, SnakeUpsampleHead
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
        if p.feature_extractor == "mel":
            self.feature_extractor = MelFeatures(p.sample_rate, p.n_fft, p.hop_length,
                                                 p.n_mels)
        elif p.feature_extractor == "audio":
            self.feature_extractor = AudioFeatures(p.input_feature, p.n_mels)
        else:
            raise NotImplementedError(
                f"feature_extractor={p.feature_extractor!r} is not ported yet")
        if p.backbone != "vocos":
            raise NotImplementedError(f"backbone={p.backbone!r} is not ported yet")
        self.backbone = VocosBackbone(self.feature_extractor.dim, p.dim, p.n_layers,
                                      p.mlp_ratio, cond_dim=p.cond_dim)
        if p.head == "istft":
            self.head = ISTFTHead(self.backbone.dim, p.n_fft, p.hop_length)
        elif p.head == "snake_upsample":
            self.head = SnakeUpsampleHead(self.backbone.dim, p.upsample_rates,
                                          channels=p.upsample_channels,
                                          resblock_kernel_sizes=p.resblock_kernel_sizes,
                                          taps=p.snake_taps)
        else:
            raise NotImplementedError(f"head={p.head!r} is not ported yet")

    def fold_inference(self, target: int = 384, threshold: int = 256) -> bool:
        """Swap a ``SnakeUpsampleHead`` for its exact folded equivalent
        (``folded_head.FoldedSnakeHead``): stages narrower than ``threshold``
        run folded at a width of at most ``target``. Load the weights first:
        the transform scatters them. Returns whether the head was folded (other
        heads are left as they are). Inference only."""
        if not isinstance(self.head, SnakeUpsampleHead):
            return False
        self.head = FoldedSnakeHead(self.head, target=target, threshold=threshold)
        return True

    def features(self, inputs) -> torch.Tensor:
        """The extractor's features, in the model's dtype."""
        return self.feature_extractor(inputs).to(self.backbone.embed.weight.dtype)

    def forward(self, inputs: tp.Mapping[str, torch.Tensor]) -> torch.Tensor:
        """``inputs`` holds ``waveform`` (mel extractor) or the feature named by
        ``input_feature``, and optionally ``speaker_emb`` -> waveform."""
        cond = inputs.get("speaker_emb") if isinstance(inputs, dict) else None
        return self.from_features(self.features(inputs), cond)

    def from_features(self, feats: torch.Tensor,
                      cond: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, feat_dim) -> (B, (T-1)·hop) waveform: T feature frames give
        exactly (T-1)·hop samples, the JAX package's uniform contract."""
        wav = self.head(self.backbone(feats, cond))
        return wav[..., : (feats.shape[1] - 1) * self.params.hop_length]
