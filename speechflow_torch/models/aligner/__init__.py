"""The GlowTTS forced aligner (counterpart of ``speechflow_tpu.models.aligner``)."""

from speechflow_torch.models.aligner.batch_processor import AlignerBatchProcessor
from speechflow_torch.models.aligner.criterion import AlignerCriterion
from speechflow_torch.models.aligner.model import GlowTTSAligner, GlowTTSParams

__all__ = ["GlowTTSAligner", "GlowTTSParams", "AlignerCriterion", "AlignerBatchProcessor"]
