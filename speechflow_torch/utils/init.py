"""Keyword filtering for config-built objects (counterpart of
``filter_kwargs`` in ``speechflow_tpu/utils/init.py``)."""

from __future__ import annotations

import inspect
import logging
import typing as tp

__all__ = ["filter_kwargs"]

LOGGER = logging.getLogger("speechflow_torch")


def filter_kwargs(fn: tp.Callable, cfg: tp.Mapping, warn: bool = True) -> dict:
    """The entries of ``cfg`` that ``fn`` takes (all of them if it takes
    ``**kwargs``); the others are dropped, with a warning unless ``warn`` is off."""
    params = inspect.signature(fn).parameters
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return dict(cfg)
    unknown = [k for k in cfg if k not in params]
    if unknown and warn:
        LOGGER.warning("%s: ignoring unknown config keys %s", getattr(fn, "__name__", fn),
                       unknown)
    return {k: v for k, v in cfg.items() if k in params}
