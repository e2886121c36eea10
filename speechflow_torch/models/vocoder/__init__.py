"""Vocoder (counterpart of ``speechflow_tpu.models.vocoder``)."""

from speechflow_torch.models.vocoder.model import Vocos, VocosParams

__all__ = ["Vocos", "VocosParams"]
