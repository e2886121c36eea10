"""Collated batch -> ``TTSForwardInput`` (counterpart of
``speechflow_tpu/models/tts/batch_processor.py``, its inference half): the
collated numpy arrays become CPU tensors of the same dtypes, the SSML
modifiers of ``additional`` included. The training targets and the speaker
range table wait for the trainer."""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from speechflow_torch.data.collate import CollatedTTS
from speechflow_torch.models.tts.data_types import TTSForwardInput

__all__ = ["TTSBatchProcessor"]


def _tensor(x) -> tp.Optional[torch.Tensor]:
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


class TTSBatchProcessor:
    def __call__(self, c: CollatedTTS) -> TTSForwardInput:
        extra = c.additional or {}
        fields = {f.name for f in dataclasses.fields(TTSForwardInput)}
        values = {name: getattr(c, name, None) for name in fields}
        values.update({k: extra.get(k) for k in fields if k in extra})
        return TTSForwardInput(**{k: _tensor(v) for k, v in values.items()})
