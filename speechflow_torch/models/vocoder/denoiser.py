"""Spectral-bias denoiser for vocoder outputs (counterpart of
``speechflow_tpu/models/vocoder/denoiser.py``, WaveGlow-style): the vocoder's
"bias" audio from a constant feature input (``mode="zeros"``, or
``"normal"``: log(1e-5) everywhere) gives a noise profile, its mean STFT
magnitude over frames; ``__call__`` subtracts ``strength`` times it from the
audio's magnitude (floored at 0) and resynthesizes with the audio's phase.

The bias goes through the module the caller passes, as served: on the
flagship that is the folded BigVGAN head of ``VocoderEvaluationInterface``'s
model, whose anti-alias activations are the CUDA kernels on the GPU.
"""

from __future__ import annotations

import math

import torch

from speechflow_torch.ops.stft import istft, stft

__all__ = ["Denoiser"]


class Denoiser:
    def __init__(self, vocoder, n_mels: int = 100, n_fft: int = 1024, hop_length: int = 256,
                 mode: str = "zeros", bias_frames: int = 88):
        """``vocoder``: a module with ``from_features`` (a ``Vocos``); the bias
        is made on its device and in its parameters' dtype."""
        self.n_fft = n_fft
        self.hop = hop_length
        p = next(vocoder.parameters())
        fill = 0.0 if mode == "zeros" else math.log(1e-5)
        feats = torch.full((1, bias_frames, n_mels), fill, device=p.device, dtype=p.dtype)
        with torch.inference_mode():
            bias_audio = vocoder.from_features(feats).float()
            self.bias_spec = stft(bias_audio, n_fft, hop_length).abs().mean(dim=1, keepdim=True)

    def __call__(self, audio: torch.Tensor, strength: float = 0.05) -> torch.Tensor:
        """(T,) or (B, T) audio on the bias's device -> the same shape."""
        squeeze = audio.ndim == 1
        audio = audio[None] if squeeze else audio
        spec = stft(audio, self.n_fft, self.hop)
        mag = torch.clamp(spec.abs() - strength * self.bias_spec, min=0.0)
        clean = istft(torch.polar(mag, torch.angle(spec)), self.n_fft, self.hop,
                      length=audio.shape[-1])
        return clean[0] if squeeze else clean
