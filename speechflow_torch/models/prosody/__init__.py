"""Word-level prosody prediction (counterpart of ``speechflow_tpu.models.prosody``)."""

from speechflow_torch.models.prosody.criterion import ProsodyCriterion, eer
from speechflow_torch.models.prosody.interface import ProsodyPredictionInterface, hash_tokenize
from speechflow_torch.models.prosody.model import ProsodyModel, ProsodyParams

__all__ = ["ProsodyModel", "ProsodyParams", "ProsodyCriterion", "eer",
           "ProsodyPredictionInterface", "hash_tokenize"]
