"""Acoustic model (counterpart of ``speechflow_tpu.models.tts``)."""

from speechflow_torch.models.tts.criterion import TTSCriterion
from speechflow_torch.models.tts.data_types import TTSForwardInput, TTSOutput, TTSTarget
from speechflow_torch.models.tts.model import ParallelTTSModel, ParallelTTSParams
from speechflow_torch.models.tts.xtts import (
    PromptEncoder,
    XTTSBatchProcessor,
    XTTSModel,
    XTTSParams,
    xtts_criterion,
)

__all__ = ["ParallelTTSModel", "ParallelTTSParams", "TTSCriterion", "TTSForwardInput",
           "TTSOutput", "TTSTarget", "XTTSModel", "XTTSParams", "PromptEncoder",
           "XTTSBatchProcessor", "xtts_criterion"]
