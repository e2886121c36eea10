"""Losses with iteration schedules (counterpart of
``speechflow_tpu/training/losses``: the base and the zoo, ``LOSSES`` and
``build_loss``)."""

from speechflow_torch.training.losses.base import BaseLoss, LossSchedule
from speechflow_torch.training.losses.zoo import (
    LOSSES,
    CTCLoss,
    DiffSpectralLoss,
    DurationLoss,
    GateLoss,
    GuidedAttentionLoss,
    InverseSpeakerLoss,
    MLELoss,
    RegressionLoss,
    SoftDTWLoss,
    SpectralLoss,
    SSIMLoss,
    VAELoss,
    build_loss,
)

__all__ = [
    "BaseLoss", "LossSchedule",
    "SpectralLoss", "GateLoss", "RegressionLoss", "VAELoss", "MLELoss",
    "GuidedAttentionLoss", "InverseSpeakerLoss", "DurationLoss", "SoftDTWLoss",
    "DiffSpectralLoss", "SSIMLoss", "CTCLoss",
    "LOSSES", "build_loss",
]
