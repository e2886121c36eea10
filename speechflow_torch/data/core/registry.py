"""Handlers' dataflow contracts (counterpart of
``speechflow_tpu/data/core/registry.py``).

A handler declares the sample fields it reads (``inputs``), writes
(``outputs``) and may touch when present (``optional``) through
``PipeRegistry.registry``; ``meta`` reads them back (through a bound
``functools.partial`` too), ``check`` validates that an ordered pipe only
reads what an earlier handler or the parser produced, and ``filter`` is the
inference-time surgery: drop handlers by name or by a field they produce,
keep the part before or after a named handler.
"""

from __future__ import annotations

import typing as tp

__all__ = ["PipeRegistry"]


class PipeRegistry:
    _registry: tp.Dict[str, dict] = {}

    @classmethod
    def registry(cls, inputs: tp.Optional[tp.Set[str]] = None,
                 outputs: tp.Optional[tp.Set[str]] = None,
                 optional: tp.Optional[tp.Set[str]] = None):
        def deco(fn):
            meta = {"fn": fn, "name": fn.__name__, "inputs": set(inputs or ()),
                    "outputs": set(outputs or ()), "optional": set(optional or ())}
            cls._registry[fn.__qualname__] = meta
            fn.__pipe_meta__ = meta
            return fn

        return deco

    @staticmethod
    def meta(fn: tp.Callable) -> dict:
        """The contract of ``fn`` (a partial's or bound method's inner
        function's); an undeclared callable reads and writes nothing."""
        m = getattr(fn, "__pipe_meta__", None)
        if m is not None:
            return m
        inner = getattr(fn, "__func__", None) or getattr(fn, "func", None)
        if inner is not None:
            return PipeRegistry.meta(inner)
        return {"fn": fn, "name": getattr(fn, "__name__", str(fn)),
                "inputs": set(), "outputs": set(), "optional": set()}

    @classmethod
    def check(cls, pipe: tp.Sequence[tp.Callable],
              initial_fields: tp.Optional[tp.Set[str]] = None) -> bool:
        """True if every handler's inputs are produced upstream, else a
        ``ValueError`` naming the first handler that misses some."""
        available = set(initial_fields or ())
        for fn in pipe:
            m = cls.meta(fn)
            missing = m["inputs"] - available
            if missing:
                raise ValueError(
                    f"handler '{m['name']}' requires fields {sorted(missing)} "
                    f"not produced upstream (have {sorted(available)})")
            available |= m["outputs"]
        return True

    @classmethod
    def filter(cls, pipe: tp.Sequence[tp.Callable],
               drop_names: tp.Optional[tp.Set[str]] = None,
               drop_fields: tp.Optional[tp.Set[str]] = None,
               before: tp.Optional[str] = None,
               after: tp.Optional[str] = None) -> tp.List[tp.Callable]:
        out = list(pipe)
        names = [cls.meta(f)["name"] for f in out]
        if before is not None and before in names:
            out = out[:names.index(before)]
            names = names[:len(out)]
        if after is not None and after in names:
            out = out[names.index(after) + 1:]
            names = [cls.meta(f)["name"] for f in out]
        if drop_names:
            out = [f for f, n in zip(out, names) if n not in drop_names]
        if drop_fields:
            out = [f for f in out if not (cls.meta(f)["outputs"] & drop_fields)]
        return out
