"""Grapheme-to-phoneme model (counterpart of ``speechflow_tpu.models.g2p``)."""

from speechflow_torch.models.g2p.model import (
    G2P,
    align_lexicon,
    mine_g2p_lexicon,
    normalize_word,
    phoneme_error_rate,
    train_g2p,
)

__all__ = ["G2P", "train_g2p", "mine_g2p_lexicon", "align_lexicon", "normalize_word",
           "phoneme_error_rate"]
