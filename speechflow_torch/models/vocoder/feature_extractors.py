"""Vocoder feature extractors (counterpart of
``speechflow_tpu/models/vocoder/feature_extractors.py``): ``MelFeatures``,
log-mel computed on the device from the waveform, ``AudioFeatures``, the
pass-through of precomputed features, and ``CodecFeatures``, the quantized
latents of a trainable RVQ codec (``models/codec/rvq.py``). The ``tts``
extractor, the acoustic model itself, is ``tts_features.TTSFeatures``."""

from __future__ import annotations

import typing as tp

import torch
import torch.nn as nn

from speechflow_torch.models.layers import flax_init_
from speechflow_torch.ops import mel as M
from speechflow_torch.ops import stft as S

__all__ = ["MelFeatures", "AudioFeatures", "CodecFeatures"]


class MelFeatures(nn.Module):
    """``inputs["waveform"]`` (B, N) -> log-mel (B, N//hop + 1, n_mels): all
    centered frames, so the generator's (T-1)·hop crop gives back N samples
    when hop divides N. Computed in float32 (the log of a magnitude clipped
    at 1e-5), or float64 from a float64 waveform; the caller casts the
    features to the model's dtype."""

    def __init__(self, sample_rate: int = 24000, n_fft: int = 1024, hop_length: int = 256,
                 n_mels: int = 100, normalize: bool = False):
        super().__init__()
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.n_mels = n_mels
        self.normalize = normalize

    @property
    def dim(self) -> int:
        return self.n_mels

    def forward(self, inputs) -> torch.Tensor:
        wav = inputs["waveform"] if isinstance(inputs, dict) else inputs.waveform
        # f32 under a training autocast too, as the JAX package computes it
        with torch.autocast(device_type=wav.device.type, enabled=False):
            mag = S.magnitude(wav.to(torch.promote_types(wav.dtype, torch.float32)),
                              self.n_fft, self.hop_length)
            mel = M.amp_to_db(M.linear_to_mel(mag, self.sample_rate, self.n_mels))
            return M.normalize_mel(mel) if self.normalize else mel


class AudioFeatures(nn.Module):
    """Pass through a precomputed feature stream (``mel``, ``ssl_feat``,
    ``ac_feat``), projected to ``proj_dim`` by a linear layer when one is given;
    ``dim`` is the width it hands on."""

    def __init__(self, feature: str = "mel", dim_in: int = 100,
                 proj_dim: tp.Optional[int] = None):
        super().__init__()
        self.feature = feature
        self.dim = proj_dim or dim_in
        self.proj = flax_init_(nn.Linear(dim_in, proj_dim)) if proj_dim is not None else None

    def forward(self, inputs) -> torch.Tensor:
        feat = inputs[self.feature] if isinstance(inputs, dict) \
            else getattr(inputs, self.feature)
        return feat if self.proj is None else self.proj(feat)


class CodecFeatures(nn.Module):
    """Waveform -> codec encoder -> residual VQ -> quantized latents (B, N/hop,
    latent_dim). Trained with the vocoder, it returns ``(q, {"codec_vq": loss})``
    (the commitment loss joins the generator's losses); frozen, the detached
    ``q`` alone."""

    def __init__(self, codec_params: tp.Optional[dict] = None, freeze: bool = False):
        super().__init__()
        from speechflow_torch.models.codec.rvq import CodecParams, NeuralCodec

        self.codec = flax_init_(NeuralCodec(CodecParams.create(dict(codec_params or {}))))
        self.freeze = freeze
        self.dim = self.codec.p.latent_dim
        self.hop = self.codec.hop

    def forward(self, inputs):
        wav = inputs["waveform"] if isinstance(inputs, dict) else inputs.waveform
        q, _, vq_loss = self.codec.rvq(self.codec.encode_latent(wav))
        if self.freeze:
            return q.detach()
        return q, {"codec_vq": vq_loss}
