"""The per-sample feature cache (counterpart of ``DumpProcessor`` in
``speechflow_tpu/data/core/processor.py``), built from a data config's
``processor.dump`` section.

One pickle a sample, named by the sha256 of its ``file_path`` (else its
``uid``), maps ``handler|param-hash`` (the handler's name and the first 8 hex
digits of the sha256 of its sorted parameters' repr, as the JAX package keys
them) to the fields that handler produced. A handler listed in ``handlers``,
or every handler with ``full_dump``, is skipped where its key is cached and
its fields are set from the cache instead; ``update_handlers`` are always
recomputed. A sample whose handlers fail is appended to ``skip_samples.txt``
and skipped from then on. A write goes to a temporary file first and replaces
the pickle atomically, as loader workers may write the same sample.

The cached fields of a handler are its declared outputs and, unlike the JAX
package's, the declared optional fields present on the sample: the contour
handlers (``signal_enhancement``, ``clip``, ``normalize``, ...) change pitch or
energy in place and declare them optional only, so a JAX cache stores nothing
for them and a cached pass there gives the contours as they were before those
handlers ran. A cache the JAX package wrote is read all the same: its classes
(``AudioChunk``, ``Timestamps``, ...) are read as the port's counterparts of the
same module and name, and a class without one raises by name.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import typing as tp
from pathlib import Path

from speechflow_torch.data.core.registry import PipeRegistry

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["DumpProcessor"]


def _handler_key(fn: tp.Callable, params: tp.Optional[dict] = None) -> str:
    name = PipeRegistry.meta(fn)["name"]
    ph = hashlib.sha256(repr(sorted((params or {}).items())).encode()).hexdigest()[:8]
    return f"{name}|{ph}"


class DumpProcessor:
    def __init__(self, dump_path: tp.Union[str, Path], handlers: tp.Sequence[str] = (),
                 update_handlers: tp.Sequence[str] = (), full_dump: bool = False):
        self.dump_path = Path(dump_path)
        self.dump_path.mkdir(parents=True, exist_ok=True)
        self.handlers = set(handlers)
        self.update_handlers = set(update_handlers)
        self.full_dump = full_dump
        self._skip_file = self.dump_path / "skip_samples.txt"
        self.skip_samples: tp.Set[str] = set()
        if self._skip_file.exists():
            self.skip_samples = set(self._skip_file.read_text().splitlines())
        #: handler applications served from the cache, and computed
        self.hits = 0
        self.misses = 0

    @staticmethod
    def sample_key(ds) -> str:
        return str(ds.file_path or ds.uid)

    def file_for(self, ds) -> Path:
        return self.dump_path / f"{hashlib.sha256(self.sample_key(ds).encode()).hexdigest()}.pkl"

    def load(self, ds) -> dict:
        """The sample's cache (empty if none, or if the file is corrupt)."""
        from speechflow_torch.training.saver import UnmappedClassError, load_pickle

        f = self.file_for(ds)
        if not f.exists():
            return {}
        try:
            return load_pickle(f.read_bytes())
        except UnmappedClassError:
            raise
        except Exception as e:
            LOGGER.warning("corrupt dump file %s (%r), ignoring", f, e)
            return {}

    def save(self, ds, payload: dict) -> None:
        target = self.file_for(ds)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_bytes(pickle.dumps(payload, protocol=5))
        os.replace(tmp, target)

    def _dumps(self, name: str) -> bool:
        return self.full_dump or name in self.handlers

    def is_cached(self, fn: tp.Callable, params: tp.Optional[dict], cache: dict) -> bool:
        name = PipeRegistry.meta(fn)["name"]
        return (name not in self.update_handlers and self._dumps(name)
                and _handler_key(fn, params) in cache)

    def apply_cached(self, ds, fn: tp.Callable, params: tp.Optional[dict], cache: dict) -> None:
        for k, v in cache[_handler_key(fn, params)].items():
            if hasattr(ds, k):
                setattr(ds, k, v)
            else:
                ds.additional[k] = v
        self.hits += 1

    def store_outputs(self, ds, fn: tp.Callable, params: tp.Optional[dict],
                      cache: dict) -> bool:
        """Put the fields ``fn`` produced into ``cache``; False if it is not cached."""
        meta = PipeRegistry.meta(fn)
        self.misses += 1
        if not self._dumps(meta["name"]):
            return False
        outs = {}
        for name in meta["outputs"] | meta["optional"]:
            val = ds.get(name)
            if val is not None:
                outs[name] = val
        cache[_handler_key(fn, params)] = outs
        return True

    def blacklist(self, ds) -> None:
        key = self.sample_key(ds)
        if key not in self.skip_samples:
            self.skip_samples.add(key)
            with self._skip_file.open("a") as f:
                f.write(key + "\n")
