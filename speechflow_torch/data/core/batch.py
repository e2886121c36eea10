"""A processed batch (counterpart of ``speechflow_tpu/data/core/batch.py``):
the samples that survived their handlers, their collate, and where they came
from."""

from __future__ import annotations

import typing as tp
from dataclasses import dataclass

__all__ = ["Batch"]


@dataclass
class Batch:
    size: int
    is_last: bool = False
    data_samples: tp.Optional[list] = None
    collated_samples: tp.Optional[tp.Any] = None
    tag: tp.Optional[str] = None

    def __len__(self) -> int:
        return self.size
