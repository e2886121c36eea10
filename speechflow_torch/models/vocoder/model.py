"""Vocos generator (counterpart of ``speechflow_tpu/models/vocoder/model.py``):
features -> backbone -> head, each chosen by the params.

- feature extractors: ``mel`` (log-mel on the device), ``audio`` (a
  precomputed stream), ``codec`` (RVQ codec latents, with the commitment
  loss), ``tts`` (the acoustic model, with its own losses; E2E GAN-TTS);
- backbones: ``vocos`` (ConvNeXt, optional ``cond_dim`` speaker
  conditioning), ``dummy`` (the identity);
- heads: ``istft``, ``snake_upsample`` (BigVGAN; ``fold_inference``),
  ``imdct_symexp``, ``imdct_cos``, ``dac``, ``nsf_hifigan``, ``nsf_istft``.

An extractor with losses (``codec``, ``tts``) makes ``forward`` return
``(wav, ft_losses)``. The NSF heads take a frame-level F0: the batch's
``pitch``, else the acoustic model's pitch prediction (``tts``), with the
style embedding ``style_emb``, else ``speaker_emb``; their sine-source noise
is ``sine_noise`` (a pair of standard normals, ``nsf.SineGen``) or drawn from
torch's generator.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.models.vocoder.backbones import DummyBackbone, VocosBackbone
from speechflow_torch.models.vocoder.feature_extractors import (
    AudioFeatures,
    CodecFeatures,
    MelFeatures,
)
from speechflow_torch.models.vocoder.folded_head import FoldedSnakeHead
from speechflow_torch.models.vocoder.heads import (
    DACHead,
    IMDCTCosHead,
    IMDCTSymExpHead,
    ISTFTHead,
    SnakeUpsampleHead,
)
from speechflow_torch.training.base_model import BaseModelParams
from speechflow_torch.utils.profiler import span

__all__ = ["Vocos", "VocosParams", "split_output"]


@dataclasses.dataclass
class VocosParams(BaseModelParams):
    sample_rate: int = 24000
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 100
    feature_extractor: str = "mel"     # mel | audio | codec | tts
    input_feature: str = "mel"
    tts_params: dict = dataclasses.field(default_factory=dict)
    codec_params: dict = dataclasses.field(default_factory=dict)
    codec_freeze: bool = False
    dac_codec_params: dict = dataclasses.field(default_factory=dict)
    backbone: str = "vocos"            # vocos | dummy
    head: str = "istft"
    dim: int = 512
    n_layers: int = 8
    mlp_ratio: int = 3
    cond_dim: tp.Optional[int] = None
    upsample_rates: tp.Tuple[int, ...] = (8, 8, 2, 2)
    upsample_channels: int = 256
    resblock_kernel_sizes: tp.Tuple[int, ...] = (3,)
    snake_taps: int = 12
    #: activation checkpointing of the head's plain snakes under autograd
    snake_remat: bool = True
    mdct_frame_len: int = 512
    style_dim: int = 128
    n_harmonics: int = 8


class Vocos(nn.Module):
    def __init__(self, params: VocosParams):
        super().__init__()
        p = self.params = params
        if p.feature_extractor == "mel":
            self.feature_extractor = MelFeatures(p.sample_rate, p.n_fft, p.hop_length,
                                                 p.n_mels)
        elif p.feature_extractor == "audio":
            self.feature_extractor = AudioFeatures(p.input_feature, p.n_mels)
        elif p.feature_extractor == "codec":
            self.feature_extractor = CodecFeatures(p.codec_params, freeze=p.codec_freeze)
        elif p.feature_extractor == "tts":
            from speechflow_torch.models.tts import ParallelTTSParams
            from speechflow_torch.models.vocoder.tts_features import TTSFeatures

            self.feature_extractor = TTSFeatures(
                ParallelTTSParams.create(dict(p.tts_params, n_mels=p.n_mels)))
        else:
            raise ValueError(p.feature_extractor)

        feat_dim = self.feature_extractor.dim
        if p.backbone == "vocos":
            self.backbone = VocosBackbone(feat_dim, p.dim, p.n_layers, p.mlp_ratio,
                                          cond_dim=p.cond_dim)
        elif p.backbone == "dummy":
            self.backbone = DummyBackbone(feat_dim)
        else:
            raise ValueError(p.backbone)

        bdim = self.backbone.dim
        self.nsf_head = p.head.startswith("nsf")
        if p.head == "istft":
            self.head = ISTFTHead(bdim, p.n_fft, p.hop_length)
        elif p.head == "snake_upsample":
            self.head = SnakeUpsampleHead(bdim, p.upsample_rates, channels=p.upsample_channels,
                                          resblock_kernel_sizes=p.resblock_kernel_sizes,
                                          taps=p.snake_taps, remat=p.snake_remat)
        elif p.head == "imdct_symexp":
            self.head = IMDCTSymExpHead(bdim, p.mdct_frame_len)
        elif p.head == "imdct_cos":
            self.head = IMDCTCosHead(bdim, p.mdct_frame_len)
        elif p.head == "dac":
            self.head = DACHead(bdim, p.hop_length, p.dac_codec_params)
        elif p.head == "nsf_hifigan":
            from speechflow_torch.models.vocoder.nsf import NSFHiFiGANHead

            self.head = NSFHiFiGANHead(bdim, p.upsample_rates, channels=p.upsample_channels,
                                       style_dim=p.style_dim, sample_rate=p.sample_rate,
                                       n_harmonics=p.n_harmonics)
        elif p.head == "nsf_istft":
            from speechflow_torch.models.vocoder.nsf import NSFiSTFTHead

            self.head = NSFiSTFTHead(bdim, p.n_fft, p.hop_length, style_dim=p.style_dim,
                                     sample_rate=p.sample_rate, n_harmonics=p.n_harmonics)
        else:
            raise ValueError(p.head)

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

    @property
    def dtype(self) -> torch.dtype:
        return next(self.head.parameters()).dtype

    def features(self, inputs):
        """The extractor's output: features in the model's dtype, or the
        ``(features, ft_losses[, aux])`` tuple of an extractor with losses."""
        out = self.feature_extractor(inputs)
        if isinstance(out, tuple):
            return (out[0].to(self.dtype), *out[1:])
        return out.to(self.dtype)

    def _resolve_f0_style(self, inputs, aux: tp.Mapping):
        """The frame-level F0 (the inputs' ``pitch``, else ``aux``'s) and the style
        (``style_emb``, else ``speaker_emb``)."""
        f0 = style = None
        if isinstance(inputs, dict):
            f0 = inputs.get("pitch")
            style = inputs.get("style_emb", inputs.get("speaker_emb"))
        if f0 is None:
            f0 = aux.get("pitch")
        if f0 is None:
            raise ValueError(
                f"head {self.params.head!r} needs a frame-level F0: provide a "
                "'pitch' batch field (pitch handler in the data pipe) or use "
                "the 'tts' feature extractor whose pitch prediction is wired "
                "through automatically")
        return f0, style

    def forward(self, inputs: tp.Mapping[str, torch.Tensor], sine_noise=None,
                generator: tp.Optional[torch.Generator] = None):
        """``inputs`` holds ``waveform`` (mel, codec), the feature named by
        ``input_feature`` (audio) or ``tts_inputs`` (tts), optionally
        ``speaker_emb``, and for an NSF head ``pitch`` / ``style_emb`` ->
        waveform (B, (T-1)·hop), or ``(waveform, ft_losses)``."""
        feats = self.features(inputs)
        ft_losses, aux = None, {}
        if isinstance(feats, tuple):
            feats, ft_losses, *rest = feats
            aux = rest[0] if rest else {}
        cond = inputs.get("speaker_emb") if isinstance(inputs, dict) else None
        f0 = style = None
        if self.nsf_head:
            f0, style = self._resolve_f0_style(inputs, aux)
        wav = self.from_features(feats, cond, f0, style, sine_noise, generator)
        return wav if ft_losses is None else (wav, ft_losses)

    def from_features(self, feats: torch.Tensor, cond: tp.Optional[torch.Tensor] = None,
                      f0: tp.Optional[torch.Tensor] = None,
                      style: tp.Optional[torch.Tensor] = None, sine_noise=None,
                      generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, feat_dim) -> (B, (T-1)·hop) waveform: T feature frames give
        exactly (T-1)·hop samples, the JAX package's uniform contract. An NSF
        head takes ``f0`` (B, T') in Hz, padded with zeros or cut to T (all
        zeros, a fully unvoiced source, when None), and the AdaIN ``style``."""
        with span("vocoder.from_features"):
            h = self.backbone(feats, cond)
            t = feats.shape[1]
            if self.nsf_head:
                if f0 is None:
                    f0 = feats.new_zeros(feats.shape[:2])
                if f0.shape[1] < t:
                    f0 = F.pad(f0, (0, t - f0.shape[1]))
                with span("vocoder.head"):
                    wav = self.head(h, f0[:, :t], style, noise=sine_noise,
                                    generator=generator)
            else:
                with span("vocoder.head"):
                    wav = self.head(h)
            return wav[..., : (t - 1) * self.params.hop_length]


def split_output(out) -> tp.Tuple[torch.Tensor, tp.Dict[str, torch.Tensor]]:
    """``Vocos.forward``'s output as ``(waveform, ft_losses)``: the losses of an
    extractor with losses (``codec``, ``tts``), else ``{}``."""
    if isinstance(out, tuple):
        return out[0], dict(out[1])
    return out, {}
