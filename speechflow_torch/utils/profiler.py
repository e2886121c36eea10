"""Wall-clock profiling of named blocks, switched on by environment variables
(counterpart of ``speechflow_tpu/utils/profiler.py``).

``with Profiler("tag"):`` times its block; with ``device_sync`` (a tensor, or
a sequence of them) it first waits for the CUDA stream of each tensor on a
card, as the JAX package waits for its arrays (``block_until_ready``).
``ProfilerSink`` keeps this process's timings by tag (count, total, mean,
std). Where an experiment's ``LoggingServer`` runs (its address in
``SPEECHFLOW_LOG_ADDR``, which data workers and ranks inherit), each timing is
also sent there, so the workers' timings reach the summary the server writes
at the end of the experiment's log. ``profiling_enabled("DATAPIPE")`` reads
``DATAPIPE_PROFILING``; the data processor times each handler under it.
"""

from __future__ import annotations

import os
import statistics
import threading
import time
import typing as tp
from collections import defaultdict

__all__ = ["Profiler", "ProfilerSink", "profiling_enabled"]


def profiling_enabled(kind: str = "DATAPIPE") -> bool:
    return os.environ.get(f"{kind}_PROFILING", "0") not in ("0", "", "false", "False")


class ProfilerSink:
    """Thread-safe record of this process's timings: tag -> [seconds]."""

    _lock = threading.Lock()
    _events: tp.Dict[str, tp.List[float]] = defaultdict(list)

    @classmethod
    def add(cls, tag: str, seconds: float) -> None:
        with cls._lock:
            cls._events[tag].append(seconds)

    @classmethod
    def summary(cls) -> tp.Dict[str, tp.Dict[str, float]]:
        with cls._lock:
            return {tag: {"count": len(vals), "total": sum(vals),
                          "mean": statistics.fmean(vals),
                          "std": statistics.pstdev(vals) if len(vals) > 1 else 0.0}
                    for tag, vals in cls._events.items()}

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._events.clear()


def _to_server(tag: str, seconds: float) -> None:
    """Send a timing to the experiment's ``LoggingServer``, if one runs."""
    from speechflow_torch.logging.server import (
        LOG_ADDR_ENV,
        attach_socket_handler,
        profiler_record,
    )

    address = os.environ.get(LOG_ADDR_ENV)
    if address:
        attach_socket_handler(address).handle(profiler_record(tag, seconds))


class Profiler:
    """``with Profiler("stft"):`` times the block (see the module docstring)."""

    def __init__(self, tag: str = "", enable: bool = True, device_sync: tp.Any = None):
        self.tag = tag
        self.enable = enable
        self.device_sync = device_sync
        self.duration = 0.0
        self._t0 = 0.0

    def __enter__(self) -> "Profiler":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.device_sync is not None:
            import torch

            sync = self.device_sync
            for t in (sync if isinstance(sync, (list, tuple)) else [sync]):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    torch.cuda.current_stream(t.device).synchronize()
        self.duration = time.perf_counter() - self._t0
        if self.enable and self.tag:
            ProfilerSink.add(self.tag, self.duration)
            _to_server(self.tag, self.duration)
        return False

    def get_time(self) -> float:
        return self.duration
