"""Speaker embeddings (counterpart of ``speechflow_tpu.models.biometric``)."""

from speechflow_torch.models.biometric.ecapa import ECAPAEmbedder, ECAPAParams, triplet_loss

__all__ = ["ECAPAEmbedder", "ECAPAParams", "triplet_loss"]
