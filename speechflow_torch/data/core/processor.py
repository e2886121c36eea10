"""The handler chain over a sample and the per-sample feature cache
(counterpart of ``speechflow_tpu/data/core/processor.py``).

``DataProcessor.process_sample`` runs the handlers over a sample in order (a
cached handler's fields set from the ``DumpProcessor`` instead). A sample that
raises in a handler, whatever the exception, is dropped with a warning and
recorded in the cache's blacklist when ``skip_corrupted_samples`` is on (the
default, as ``DataPipeline`` builds it), and raises when it is off.
``process`` collates the survivors into a ``Batch``. Under
``DATAPIPE_PROFILING=1`` each handler is timed as ``handler.<name>`` and each
sample as ``datapipe.sample`` (``utils.profiler``; a data worker's timings reach
the experiment's ``LoggingServer``).

``DumpProcessor`` is the feature cache, built from a data config's
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

from speechflow_torch.data.core.batch import Batch
from speechflow_torch.data.core.registry import PipeRegistry
from speechflow_torch.utils.profiler import Profiler, profiling_enabled

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["DataProcessor", "DumpProcessor"]


def _handler_key(fn: tp.Callable, params: tp.Optional[dict] = None) -> str:
    name = PipeRegistry.meta(fn)["name"]
    ph = hashlib.sha256(repr(sorted((params or {}).items())).encode()).hexdigest()[:8]
    return f"{name}|{ph}"


class DumpProcessor:
    def __init__(self, dump_path: tp.Union[str, Path], fields: tp.Sequence[str] = (),
                 handlers: tp.Sequence[str] = (), update_handlers: tp.Sequence[str] = (),
                 full_dump: bool = False, persist_blacklist: bool = True):
        """``fields``: JAX's keyword, which selects nothing there or here (a
        handler's own outputs are what is stored): a value is warned of;
        ``persist_blacklist``: read and append ``skip_samples.txt`` (else the
        failed samples are kept in memory only)."""
        self.dump_path = Path(dump_path)
        self.dump_path.mkdir(parents=True, exist_ok=True)
        self.fields = set(fields)
        if self.fields:
            LOGGER.warning("DumpProcessor: fields %s select nothing (as in JAX); a "
                           "handler's outputs are what is stored", sorted(self.fields))
        self.handlers = set(handlers)
        self.update_handlers = set(update_handlers)
        self.full_dump = full_dump
        self.persist_blacklist = persist_blacklist
        self._skip_file = self.dump_path / "skip_samples.txt"
        self.skip_samples: tp.Set[str] = set()
        if self.persist_blacklist and self._skip_file.exists():
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

    def is_cached(self, ds, fn: tp.Callable, params: tp.Optional[dict], cache: dict) -> bool:
        """Whether ``cache`` (``ds``'s) holds ``fn``'s outputs under ``params``."""
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
            if not self.persist_blacklist:
                return
            with self._skip_file.open("a") as f:
                f.write(key + "\n")


class DataProcessor:
    """The handlers of a pipeline over its samples; see the module docstring.
    ``handler_params`` maps a handler's name to its config parameters (the key
    of its cached fields). Picklable, for the loaders' worker processes."""

    def __init__(self, preproc_fns: tp.Sequence[tp.Callable] = (),
                 collate_fn: tp.Optional[tp.Callable] = None,
                 handler_params: tp.Optional[tp.Mapping[str, dict]] = None,
                 skip_corrupted_samples: bool = True,
                 dump_processor: tp.Optional[DumpProcessor] = None):
        self.preproc_fns = list(preproc_fns)
        self.collate_fn = collate_fn
        self.handler_params = dict(handler_params or {})
        self.skip_corrupted_samples = skip_corrupted_samples
        self.dump = dump_processor

    def process_sample(self, ds):
        """The sample through every handler; None if it is dropped."""
        dump = self.dump
        if dump is not None and dump.sample_key(ds) in dump.skip_samples:
            return None
        cache = dump.load(ds) if dump is not None else {}
        dirty = False
        profile = profiling_enabled("DATAPIPE")
        try:
            with Profiler("datapipe.sample", enable=profile):
                for fn in self.preproc_fns:
                    name = PipeRegistry.meta(fn)["name"]
                    params = self.handler_params.get(name)
                    if dump is not None and dump.is_cached(ds, fn, params, cache):
                        dump.apply_cached(ds, fn, params, cache)
                        continue
                    with Profiler(f"handler.{name}", enable=profile):
                        ds = fn(ds)
                    if ds is None:
                        return None
                    if dump is not None:
                        dirty |= dump.store_outputs(ds, fn, params, cache)
        except Exception as e:
            LOGGER.warning("sample %s failed in preproc: %r", getattr(ds, "file_path", None), e)
            if dump is not None:
                dump.blacklist(ds)
            if self.skip_corrupted_samples:
                return None
            raise
        if dirty:
            dump.save(ds, cache)
        return ds

    def process(self, samples: tp.Sequence, is_last: bool = False,
                tag: tp.Optional[str] = None) -> tp.Optional[Batch]:
        """The samples through the handlers, the survivors collated (None if
        none survives)."""
        processed = [d for d in (self.process_sample(s) for s in samples) if d is not None]
        if not processed:
            return None
        collated = self.collate_fn(processed) if self.collate_fn else None
        return Batch(size=len(processed), is_last=is_last, data_samples=processed,
                     collated_samples=collated, tag=tag)

    def sample(self, ds):
        """A copy of a dataset's sample through the handlers (the dataset's own
        stays as it is)."""
        return self.process_sample(ds.copy())

    def batch(self, samples: tp.Sequence) -> tp.Any:
        """Copies of ``samples`` through the handlers, collated (None if none
        survives)."""
        out = self.process([s.copy() for s in samples])
        return None if out is None else out.collated_samples
