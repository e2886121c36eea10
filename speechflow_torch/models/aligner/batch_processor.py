"""The aligner's batch processor (counterpart of
``speechflow_tpu/models/aligner/batch_processor.py``): the acoustic model's
input schema."""

from __future__ import annotations

from speechflow_torch.models.tts.batch_processor import TTSBatchProcessor

__all__ = ["AlignerBatchProcessor"]


class AlignerBatchProcessor(TTSBatchProcessor):
    pass
