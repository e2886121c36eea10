"""Collated batch -> the acoustic model's inputs (counterpart of
``speechflow_tpu/models/tts/batch_processor.py``): the collated numpy arrays
become CPU tensors of the same dtypes, the SSML modifiers of ``additional``
included.

``TTSBatchProcessor()`` returns ``(TTSForwardInput, TTSTarget)``, as the JAX
processor does; a raw-text batch (the eval interface's) has no mel, so its
target holds only the token fields. A ``ranges_table`` gives each row its
speaker's stat ranges (``inputs.ranges``), as JAX's processor does.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from speechflow_torch.data.collate import CollatedTTS
from speechflow_torch.models.tts.data_types import TTSForwardInput, TTSTarget

__all__ = ["TTSBatchProcessor"]


def _tensor(x):
    if isinstance(x, dict):  # the named utterance averages
        return {k: _tensor(v) for k, v in x.items()}
    # a copy only of what is not contiguous and writable (a data server's loader hands
    # out read-only views of the received frames)
    return None if x is None else torch.from_numpy(np.require(x, requirements=("C", "W")))


def _fields(cls, c: CollatedTTS, extra: tp.Mapping) -> dict:
    """The batch's (or ``extra``'s) values of ``cls``'s fields; absent ones keep
    their defaults."""
    names = [f.name for f in dataclasses.fields(cls)]
    values = {name: getattr(c, name, None) for name in names}
    values.update({k: extra.get(k) for k in names if k in extra})
    return {k: _tensor(v) for k, v in values.items() if v is not None}


class TTSBatchProcessor:
    def __init__(self, ranges_table: tp.Optional[np.ndarray] = None):
        """``ranges_table``: (n_speakers, n_feat, 4) speaker stat ranges; each
        row's speaker's (a negative id: speaker 0's) goes into ``inputs.ranges``."""
        self.ranges_table = ranges_table

    def __call__(self, c) -> tp.Tuple[TTSForwardInput, TTSTarget]:
        """``c``: the collated batch, or a ``Batch`` holding it."""
        c = getattr(c, "collated_samples", c)
        inputs = TTSForwardInput(**_fields(TTSForwardInput, c, c.additional or {}))
        if self.ranges_table is not None and c.speaker_id is not None:
            inputs.ranges = torch.from_numpy(np.ascontiguousarray(
                np.asarray(self.ranges_table)[np.maximum(c.speaker_id, 0)]))
        return inputs, TTSTarget(**_fields(TTSTarget, c, {}))
