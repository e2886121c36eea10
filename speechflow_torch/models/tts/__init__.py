"""Acoustic model (counterpart of ``speechflow_tpu.models.tts``)."""

from speechflow_torch.models.tts.data_types import TTSForwardInput, TTSOutput
from speechflow_torch.models.tts.model import ParallelTTSModel, ParallelTTSParams

__all__ = ["ParallelTTSModel", "ParallelTTSParams", "TTSForwardInput", "TTSOutput"]
