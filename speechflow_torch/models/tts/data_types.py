"""Acoustic-model IO (counterpart of ``speechflow_tpu/models/tts/data_types.py``):
the model's inputs, the criterion's targets, the model's output, and
``ComponentState``, JAX's record of the stream between model stages."""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

__all__ = ["TTSForwardInput", "TTSTarget", "TTSOutput", "ComponentState"]

Tensor = tp.Optional[torch.Tensor]


@dataclasses.dataclass
class TTSForwardInput:
    transcription: Tensor = None          # (B, N) int
    transcription_lengths: Tensor = None  # (B,)
    speaker_id: Tensor = None             # (B,)
    lang_id: Tensor = None                # (B,)
    speaker_emb: Tensor = None            # (B, D) catalog mean embedding (read by no ported mode)
    durations: Tensor = None              # (B, N) teacher durations (teacher-forced only)
    aggregate_pitch: Tensor = None        # (B, N)
    aggregate_energy: Tensor = None
    ling_feat: Tensor = None              # (B, N, F)
    lm_feat: Tensor = None
    xpbert_feat: Tensor = None
    prosody: Tensor = None                # (B, N) int, -1 undefined
    mel: Tensor = None                    # (B, T, n_mels)
    mel_lengths: Tensor = None
    pitch: Tensor = None                  # (B, T) frame-level
    energy: Tensor = None
    ranges: Tensor = None                 # (B, n_feat, 4) speaker stat ranges (read by no mode)
    speech_quality_emb: Tensor = None     # (B, 5), a condition source
    ssl_feat: Tensor = None               # (B, T', D), a condition source
    pitch_modifier: Tensor = None         # (B, N) SSML factors, 1.0 outside a span
    volume_modifier: Tensor = None
    rate_modifier: Tensor = None
    averages: tp.Optional[tp.Dict[str, torch.Tensor]] = None  # name -> (B,) utterance values
    pad_id: int = 0

    def get(self, name: str, default=None):
        return getattr(self, name, default)

    def to(self, device, dtype: tp.Optional[torch.dtype] = None) -> "TTSForwardInput":
        """Move every tensor to ``device``; floating tensors also to ``dtype``,
        except the SSML modifiers, which stay float32 (the rate divides the
        float32 durations; the variance adaptor casts pitch and volume where
        it multiplies)."""
        def move(name, v):
            if isinstance(v, dict):
                return {k: move(name, a) for k, a in v.items()}
            if not isinstance(v, torch.Tensor):
                return v
            if dtype is not None and v.is_floating_point() and not name.endswith("_modifier"):
                return v.to(device=device, dtype=dtype)
            return v.to(device=device)
        return TTSForwardInput(**{f.name: move(f.name, getattr(self, f.name))
                                  for f in dataclasses.fields(self)})


@dataclasses.dataclass
class ComponentState:
    """The stream between model stages: content (B, L, D), its lengths, the
    global (B, D) conditions by name, and named extra content and losses."""

    content: Tensor = None
    lengths: Tensor = None
    embeddings: tp.Optional[tp.Dict[str, torch.Tensor]] = None
    additional_content: tp.Optional[tp.Dict[str, torch.Tensor]] = None
    additional_losses: tp.Optional[tp.Dict[str, torch.Tensor]] = None

    def embedding(self, name: str) -> Tensor:
        return (self.embeddings or {}).get(name)

    def with_(self, **kwargs) -> "ComponentState":
        return dataclasses.replace(self, **kwargs)

    def add_content(self, name: str, value: torch.Tensor) -> "ComponentState":
        return self.with_(additional_content={**(self.additional_content or {}), name: value})

    def add_loss(self, name: str, value: torch.Tensor) -> "ComponentState":
        return self.with_(additional_losses={**(self.additional_losses or {}), name: value})


@dataclasses.dataclass
class TTSTarget:
    mel: Tensor = None                    # (B, T, n_mels)
    mel_lengths: Tensor = None
    gate: Tensor = None                   # (B, T) stop target, 1 from the last frame on
    durations: Tensor = None              # (B, N)
    aggregate_pitch: Tensor = None
    aggregate_energy: Tensor = None
    transcription_lengths: Tensor = None
    speaker_id: Tensor = None


@dataclasses.dataclass
class TTSOutput:
    spectrogram: Tensor = None            # (S, B, T, n_mels): decoder, postnet
    spectrogram_lengths: Tensor = None
    gate: Tensor = None                   # (B, T) logits
    variance_predictions: tp.Optional[tp.Dict[str, torch.Tensor]] = None
    attention: Tensor = None              # (B, T, N) length-regulator alignment
    additional_content: tp.Optional[tp.Dict[str, torch.Tensor]] = None
    additional_losses: tp.Optional[tp.Dict[str, torch.Tensor]] = None

    @property
    def after_postnet_spectrogram(self) -> Tensor:
        """The last stage's mel (B, T, n_mels), what a vocoder is fed."""
        return None if self.spectrogram is None else self.spectrogram[-1]
