"""Losses with iteration schedules (counterpart of
``speechflow_tpu/training/losses``: the base and the part of the zoo the
acoustic model's criterion and the CTC recognizer use)."""

from speechflow_torch.training.losses.base import BaseLoss, LossSchedule
from speechflow_torch.training.losses.zoo import CTCLoss, GateLoss, RegressionLoss, SpectralLoss

__all__ = ["BaseLoss", "LossSchedule", "SpectralLoss", "GateLoss", "RegressionLoss", "CTCLoss"]
