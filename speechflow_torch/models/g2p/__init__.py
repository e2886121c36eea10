"""G2P inference (counterpart of ``speechflow_tpu.models.g2p``)."""

from speechflow_torch.models.g2p.model import G2P, normalize_word

__all__ = ["G2P", "normalize_word"]
