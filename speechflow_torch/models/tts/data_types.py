"""Acoustic-model IO (counterpart of ``speechflow_tpu/models/tts/data_types.py``;
the fields the slice reads and writes)."""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

__all__ = ["TTSForwardInput", "TTSOutput"]

Tensor = tp.Optional[torch.Tensor]


@dataclasses.dataclass
class TTSForwardInput:
    transcription: Tensor = None          # (B, N) int
    transcription_lengths: Tensor = None  # (B,)
    speaker_id: Tensor = None             # (B,)
    lang_id: Tensor = None                # (B,)
    durations: Tensor = None              # (B, N) teacher durations (teacher-forced only)
    aggregate_pitch: Tensor = None        # (B, N)
    aggregate_energy: Tensor = None
    ling_feat: Tensor = None              # (B, N, F)
    lm_feat: Tensor = None
    xpbert_feat: Tensor = None
    mel: Tensor = None                    # (B, T, n_mels)
    mel_lengths: Tensor = None

    def get(self, name: str, default=None):
        return getattr(self, name, default)

    def to(self, device, dtype: tp.Optional[torch.dtype] = None) -> "TTSForwardInput":
        """Move every tensor to ``device``; floating tensors also to ``dtype``."""
        def move(v):
            if not isinstance(v, torch.Tensor):
                return v
            if dtype is not None and v.is_floating_point():
                return v.to(device=device, dtype=dtype)
            return v.to(device=device)
        return TTSForwardInput(**{f.name: move(getattr(self, f.name))
                                  for f in dataclasses.fields(self)})


@dataclasses.dataclass
class TTSOutput:
    spectrogram: Tensor = None            # (S, B, T, n_mels): decoder, postnet
    spectrogram_lengths: Tensor = None
    gate: Tensor = None                   # (B, T) logits
    variance_predictions: tp.Optional[tp.Dict[str, torch.Tensor]] = None
    attention: Tensor = None              # (B, T, N) length-regulator alignment
    additional_content: tp.Optional[tp.Dict[str, torch.Tensor]] = None
