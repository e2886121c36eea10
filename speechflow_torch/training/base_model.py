"""Hyperparameter objects (counterpart of ``speechflow_tpu/training/base_model.py``).

The JAX package validates its params with pydantic; the port uses plain
dataclasses so it runs where pydantic is absent. ``create()`` keeps the
JAX behaviour of dropping (with a warning) keys the params do not know.
"""

from __future__ import annotations

import dataclasses
import logging
import typing as tp

__all__ = ["BaseModelParams"]

T = tp.TypeVar("T", bound="BaseModelParams")


@dataclasses.dataclass
class BaseModelParams:
    version: str = "1.0"

    @classmethod
    def create(cls: tp.Type[T], cfg: tp.Optional[tp.Mapping] = None, **kwargs) -> T:
        data = dict(cfg or {})
        data.update(kwargs)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = [k for k in data if k not in known]
        if unknown:
            logging.getLogger("speechflow_torch").warning(
                "%s: dropping unknown params %s", cls.__name__, unknown)
            data = {k: v for k, v in data.items() if k in known}
        return cls(**data)
