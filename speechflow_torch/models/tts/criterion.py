"""The acoustic model's criterion (counterpart of
``speechflow_tpu/models/tts/criterion.py``): the spectral loss over the
stacked stages, the gate's BCE, a regression loss for each variance
predictor (durations in the log(1 + d) domain the predictor outputs), and the
model's ``additional_losses`` (the CFM's ``cfm``, the VAE's, VQ's, the
discriminators' and the aligner's) passed through with their scales, and, with
``inverse_speaker_scale``, the cross-entropy of the model's
``inverse_speaker_logits`` against the speaker ids."""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from speechflow_torch.models.tts.data_types import TTSOutput, TTSTarget
from speechflow_torch.training.losses import GateLoss, LossSchedule, RegressionLoss, SpectralLoss

__all__ = ["TTSCriterion"]


class TTSCriterion:
    def __init__(
        self,
        spectral_kind: str = "l1",
        spectral_scale: float = 1.0,
        gate_scale: float = 1.0,
        variance_scales: tp.Optional[tp.Dict[str, float]] = None,
        additional_scales: tp.Optional[tp.Dict[str, float]] = None,
        inverse_speaker_scale: float = 0.0,
        schedules: tp.Optional[tp.Dict[str, LossSchedule]] = None,
    ):
        schedules = schedules or {}
        self.spectral = SpectralLoss(kind=spectral_kind, name="spectral", schedule=schedules.get(
            "spectral", LossSchedule(scale=spectral_scale)))
        self.gate = GateLoss(name="gate", schedule=schedules.get(
            "gate", LossSchedule(scale=gate_scale)))
        self.variance_scales = variance_scales or {
            "durations": 0.1, "aggregate_pitch": 0.1, "aggregate_energy": 0.1}
        self.regression = RegressionLoss(kind="l2")
        self.additional_scales = additional_scales or {}
        self.inverse_speaker_scale = inverse_speaker_scale

    def __call__(self, outputs: TTSOutput, targets: TTSTarget,
                 step: int) -> tp.Dict[str, torch.Tensor]:
        losses: tp.Dict[str, torch.Tensor] = {}
        lens = targets.mel_lengths
        if outputs.spectrogram is not None and targets.mel is not None:
            losses["spectral"] = self.spectral(outputs.spectrogram, targets.mel,
                                               step=step, lengths=lens)
        if outputs.gate is not None and targets.gate is not None:
            losses["gate"] = self.gate(outputs.gate, targets.gate, step=step, lengths=lens)
        preds = outputs.variance_predictions or {}
        for name, scale in self.variance_scales.items():
            target = getattr(targets, name, None)
            if name not in preds or target is None:
                continue
            if name == "durations":
                target = torch.log1p(torch.clamp(target, min=0.0))  # the predictor's domain
            losses[name] = scale * self.regression(preds[name], target,
                                                   lengths=targets.transcription_lengths)
        for name, val in (outputs.additional_losses or {}).items():
            losses[name] = self.additional_scales.get(name, 1.0) * val
        logits = (outputs.additional_content or {}).get("inverse_speaker_logits")
        if self.inverse_speaker_scale > 0 and logits is not None \
                and targets.speaker_id is not None:
            ce = F.cross_entropy(logits.float(), torch.clamp(targets.speaker_id, min=0).long())
            losses["inverse_speaker"] = self.inverse_speaker_scale * ce
        return losses
