"""Construction from configs (counterpart of ``speechflow_tpu/utils/init.py``):
``filter_kwargs`` keeps the entries a callable takes; ``init_class_from_config``
and ``init_method_from_config`` return a closure that calls the class or
function with the config's entries (and any overrides), filtered unless
``check_params`` is off."""

from __future__ import annotations

import inspect
import logging
import typing as tp

__all__ = ["init_class_from_config", "init_method_from_config", "filter_kwargs"]

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


def init_class_from_config(cls: type, cfg: tp.Mapping, check_params: bool = True
                           ) -> tp.Callable:
    """``ctor(**overrides)`` -> ``cls(**(cfg | overrides))``, filtered to its
    constructor's parameters."""
    def ctor(**overrides):
        kwargs = {**cfg, **overrides}
        if check_params:
            kwargs = filter_kwargs(cls.__init__, kwargs)
        return cls(**kwargs)

    return ctor


def init_method_from_config(fn: tp.Callable, cfg: tp.Mapping, check_params: bool = True
                            ) -> tp.Callable:
    """``call(*args, **overrides)`` -> ``fn(*args, **(cfg | overrides))``, filtered
    to ``fn``'s parameters."""
    def call(*args, **overrides):
        kwargs = {**cfg, **overrides}
        if check_params:
            kwargs = filter_kwargs(fn, kwargs)
        return fn(*args, **kwargs)

    return call
