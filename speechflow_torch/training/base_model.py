"""Hyperparameter objects and the model base (counterpart of
``speechflow_tpu/training/base_model.py``).

The JAX package validates its params with pydantic; the port uses plain
dataclasses so it runs where pydantic is absent. ``create()`` does what the
JAX ``create`` does: it renames ``deprecated_fields()`` (old name -> new
name; an empty new name drops the old field), drops (with a warning) keys
the params do not know, and gives each value its field's type as pydantic's
lax mode gives it (an int where a float is declared becomes a float, a list
where a tuple is declared a tuple, a dict where a params class is declared
that class). A value it cannot convert is kept as it is.
"""

from __future__ import annotations

import dataclasses
import logging
import types
import typing as tp

import torch.nn as nn

__all__ = ["BaseModelParams", "BaseModel"]

T = tp.TypeVar("T", bound="BaseModelParams")

_TRUE = {"true", "yes", "on", "1", "t", "y"}
_FALSE = {"false", "no", "off", "0", "f", "n"}


class _NoMatch(Exception):
    pass


def _scalar(value: tp.Any, kind: type) -> tp.Any:
    """``value`` as ``kind`` (bool, int, float or str) where pydantic's lax mode
    converts it; ``_NoMatch`` otherwise."""
    if kind is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.lower() in _TRUE | _FALSE:
            return value.lower() in _TRUE
    elif kind is int:
        if isinstance(value, int):
            return int(value)
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, str) and value.strip().lstrip("+-").isdigit():
            return int(value)
    elif kind is float:
        if isinstance(value, (int, float)):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value)
            except ValueError:
                pass
    elif kind is str:
        if isinstance(value, str):
            return value
    raise _NoMatch


def _convert(value: tp.Any, hint: tp.Any) -> tp.Any:
    """``value`` validated against the annotation ``hint``; ``_NoMatch`` where it
    does not fit."""
    if hint is tp.Any or hint is object:
        return value
    origin = tp.get_origin(hint)
    args = tp.get_args(hint)
    if origin in (tp.Union, types.UnionType):
        if value is None and type(None) in args:
            return None
        members = [a for a in args if a is not type(None)]
        for a in members:  # an exact match wins, as in pydantic's smart mode
            if isinstance(a, type) and type(value) is a:
                return value
        for a in members:
            try:
                return _convert(value, a)
            except _NoMatch:
                continue
        raise _NoMatch
    if origin is tp.Literal:
        if value in args:
            return value
        raise _NoMatch
    if origin is tuple:
        if not isinstance(value, (list, tuple)):
            raise _NoMatch
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_convert(v, args[0]) for v in value)
        if args and len(args) != len(value):
            raise _NoMatch
        return tuple(_convert(v, a) for v, a in zip(value, args)) if args else tuple(value)
    if origin in (list, tp.List):
        if not isinstance(value, (list, tuple)):
            raise _NoMatch
        return [_convert(v, args[0]) for v in value] if args else list(value)
    if origin in (dict, tp.Dict) or origin is getattr(tp, "Mapping", None):
        if not isinstance(value, dict):
            raise _NoMatch
        if len(args) == 2:
            return {_convert(k, args[0]): _convert(v, args[1]) for k, v in value.items()}
        return dict(value)
    if hint is None or hint is type(None):
        if value is None:
            return None
        raise _NoMatch
    if hint in (bool, int, float, str):
        return _scalar(value, hint)
    if isinstance(hint, type) and issubclass(hint, BaseModelParams):
        if isinstance(value, hint):
            return value
        if isinstance(value, dict):
            return hint.create(value)
        raise _NoMatch
    if hint in (dict, list, tuple):
        if isinstance(value, (list, tuple)) and hint in (list, tuple):
            return hint(value)
        if isinstance(value, hint):
            return value
        raise _NoMatch
    return value


@dataclasses.dataclass
class BaseModelParams:
    #: bump when fields change; ``deprecated_fields`` migrates old configs
    version: str = "1.0"

    @classmethod
    def deprecated_fields(cls) -> tp.Dict[str, str]:
        """old name -> new name, the renames ``create`` applies (an empty new
        name drops the old field)."""
        return {}

    @classmethod
    def create(cls: tp.Type[T], cfg: tp.Optional[tp.Mapping] = None, **kwargs) -> T:
        data = dict(cfg or {})
        data.update(kwargs)
        for old, new in cls.deprecated_fields().items():
            if old in data:
                val = data.pop(old)
                if new and new not in data:
                    data[new] = val
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = [k for k in data if k not in known]
        if unknown:
            logging.getLogger("speechflow_torch").warning(
                "%s: dropping unknown params %s", cls.__name__, unknown)
            data = {k: v for k, v in data.items() if k in known}
        hints = tp.get_type_hints(cls)
        for k, v in data.items():
            try:
                data[k] = _convert(v, hints.get(k, tp.Any))
            except _NoMatch:
                pass
        out = cls(**data)
        object.__setattr__(out, "_fields_set", set(data))
        return out

    @property
    def fields_set(self) -> tp.Set[str]:
        """The fields given to ``create`` (pydantic's ``model_fields_set``); for
        an instance built directly, those that differ from their defaults."""
        if "_fields_set" in self.__dict__:
            return set(self.__dict__["_fields_set"])
        out = set()
        for f in dataclasses.fields(self):
            if f.default is not dataclasses.MISSING:
                default = f.default
            elif f.default_factory is not dataclasses.MISSING:
                default = f.default_factory()
            else:
                out.add(f.name)
                continue
            if getattr(self, f.name) != default:
                out.add(f.name)
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def init_from_parent_params(self: T, parent: "BaseModelParams",
                                only_missing: bool = True) -> T:
        """Take every field both classes have from ``parent``: with
        ``only_missing`` only those not set here (``fields_set``)."""
        mine = {f.name for f in dataclasses.fields(self)}
        theirs = {f.name for f in dataclasses.fields(parent)}
        missing = mine - self.fields_set
        for name in sorted(mine & theirs):
            if not only_missing or name in missing:
                setattr(self, name, getattr(parent, name))
        return self


class BaseModel(nn.Module):
    """A module built from a params object; ``params_dict`` is its
    ``to_dict()``."""

    def __init__(self, params: BaseModelParams):
        super().__init__()
        self.params_dict = params.to_dict()

    @property
    def n_parameters(self) -> int:
        """The number of parameter elements."""
        return sum(p.numel() for p in self.parameters())
