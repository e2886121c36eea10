"""E2E TTS + vocoder: the acoustic model as the vocoder's feature extractor
(counterpart of ``speechflow_tpu/models/vocoder/tts_features.py``).

A ``ParallelTTSModel`` runs inside the generator. Its postnet mel feeds the
backbone and head, and its own losses come back as ``ft_losses`` that join the
GAN generator's loss, so text -> waveform trains end to end with one
optimizer. The call is the teacher-forced training call when the inputs carry
a mel, inference otherwise. As in the JAX package, the TTS criterion is always
called at step 0, so its gates and anneals see step 0 for the whole run.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn as nn

from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams, TTSCriterion
from speechflow_torch.models.tts.batch_processor import TTSBatchProcessor
from speechflow_torch.models.tts.data_types import TTSTarget

__all__ = ["TTSFeatures", "E2EBatchProcessor"]


class TTSFeatures(nn.Module):
    """Feature extractor = acoustic model; returns (mel, ft_losses, aux)."""

    def __init__(self, tts_params: ParallelTTSParams):
        super().__init__()
        self.tts = ParallelTTSModel(tts_params)
        self.criterion = TTSCriterion()
        self.dim = tts_params.n_mels

    def forward(self, inputs, **tts_kwargs) -> tp.Tuple[torch.Tensor, tp.Dict[str, torch.Tensor],
                                                        tp.Dict[str, torch.Tensor]]:
        """``inputs``: ``{"tts_inputs": TTSForwardInput, ...}`` or the
        ``TTSForwardInput`` itself. ``aux["pitch"]`` is the frame-level pitch for
        an NSF head: the token-level pitch prediction through the length
        regulator's attention. ``tts_kwargs`` go to the acoustic model's call
        (injected draws)."""
        tts_in = inputs["tts_inputs"] if isinstance(inputs, dict) else inputs
        training = tts_in.mel is not None
        out = self.tts(tts_in, training=training, **tts_kwargs)
        ft_losses: tp.Dict[str, torch.Tensor] = {}
        if training:
            targets = TTSTarget(
                mel=tts_in.mel, mel_lengths=tts_in.mel_lengths, durations=tts_in.durations,
                aggregate_pitch=tts_in.aggregate_pitch,
                aggregate_energy=tts_in.aggregate_energy,
                transcription_lengths=tts_in.transcription_lengths,
                speaker_id=tts_in.speaker_id)
            ft = self.criterion(out, targets, 0)
            ft_losses = {f"ft_{k}": v for k, v in ft.items()}
        aux: tp.Dict[str, torch.Tensor] = {}
        tok_pitch = (out.variance_predictions or {}).get("aggregate_pitch")
        if tok_pitch is not None and out.attention is not None:
            aux["pitch"] = torch.einsum("btn,bn->bt", out.attention.to(tok_pitch.dtype),
                                        tok_pitch)
        return out.after_postnet_spectrogram, ft_losses, aux


class E2EBatchProcessor:
    """Collated TTS batch -> ({"tts_inputs", "waveform"[, "speaker_emb"]},
    {"waveform"}) on ``device``, for the E2E generator."""

    def __init__(self, device: tp.Union[str, torch.device] = "cpu"):
        self.tts_bp = TTSBatchProcessor()
        self.device = torch.device(device)

    def __call__(self, batch) -> tp.Tuple[dict, dict]:
        tts_inputs, _ = self.tts_bp(batch)
        tts_inputs = tts_inputs.to(self.device)
        c = getattr(batch, "collated_samples", batch)
        get = (lambda k: c.get(k)) if isinstance(c, dict) else (lambda k: getattr(c, k, None))

        def tensor(x):
            return None if x is None else torch.as_tensor(x).to(self.device)

        wav = tensor(get("waveform"))
        inputs = {"tts_inputs": tts_inputs, "waveform": wav}
        if get("speaker_emb") is not None:
            inputs["speaker_emb"] = tensor(get("speaker_emb"))
        return inputs, {"waveform": wav}

