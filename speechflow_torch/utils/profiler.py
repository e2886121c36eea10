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

``with span("tag"):`` marks a model's unit of work (the counterpart of the
reference's ``MODEL_PROFILING``, which times every component's forward). The
switch is ``MODEL_PROFILING``, read once at import (``set_model_profiling``
turns it on or off later). A span takes one of three forms:

- off, and no ``torch.profiler`` recording: a flag test, nothing else;
- while ``torch.profiler`` records (whatever the switch says): a range of the
  tag on the profiler's clock, of the scope of an operator, so a trace can put
  each kernel down to the spans that launched it (a ``record_function`` range
  would also add a mark of its own to the device's timeline);
- on, without the profiler: a CUDA event pair on the current stream (none
  while that stream captures a CUDA graph, none before CUDA is initialised)
  and the host clock at its ends. Nothing waits for the device: a span is
  resolved once its end event has passed (``query``), checked at each span's
  end, or when it is read (``flush_spans``, ``ProfilerSink.summary``, the end
  of a ``LoggingServer``), which waits for it. Each resolved span feeds
  ``ProfilerSink`` (and an experiment's ``LoggingServer``) under its tag with
  its device seconds, and under ``<tag>.host`` with its host seconds (under
  its tag alone where no event was recorded), and every ``record_spans``
  block that is open, as a ``SpanRecord``. A record's ``path`` holds the spans
  open on its thread when it started, itself last: a span that opens in the
  autograd engine's thread (a backward) has no parent there.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import threading
import time
import typing as tp
from collections import defaultdict, deque

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["Profiler", "ProfilerSink", "profiling_enabled", "span", "SpanRecord",
           "set_model_profiling", "record_spans", "flush_spans"]


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
        flush_spans()
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


# -- model spans ------------------------------------------------------------------------

_model_on = profiling_enabled("MODEL")


def set_model_profiling(on: bool) -> bool:
    """Turn model spans on or off in this process; returns the previous state."""
    global _model_on
    was, _model_on = _model_on, bool(on)
    return was


class SpanRecord(tp.NamedTuple):
    """One resolved span."""
    path: tp.Tuple[str, ...]  # the spans open on its thread at its start, itself last
    start: float  # host ``perf_counter`` at its start
    host_s: float
    device_s: tp.Optional[float]  # between its CUDA events; None where none was recorded
    thread: int

    @property
    def tag(self) -> str:
        return self.path[-1]

    @property
    def parent(self) -> tp.Optional[str]:
        return self.path[-2] if len(self.path) > 1 else None


class _Spans:
    """The process's open stacks (a thread's own), its ended spans waiting for
    their end events, the events to reuse, and the open ``record_spans`` lists."""

    def __init__(self):
        self.local = threading.local()
        self.lock = threading.Lock()
        self.pending: tp.Deque[tuple] = deque()
        # resolved spans' events, used again: creating one costs ~20 us of host
        self.free: tp.List[torch.cuda.Event] = []
        self.recorders: tp.List[tp.List[SpanRecord]] = []

    def stack(self) -> tp.List[str]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def event(self) -> tp.Optional[torch.cuda.Event]:
        """A recorded timing event on the current stream, or None where there is
        no device work to time or the stream captures a graph."""
        if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
            return None
        with self.lock:
            ev = self.free.pop() if self.free else None
        ev = ev or torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ended(self, item: tuple) -> None:
        with self.lock:
            self.pending.append(item)
            done = self._resolve(wait=False)
        _deliver(done, self.recorders)

    def flush(self) -> None:
        with self.lock:
            done = self._resolve(wait=True)
        _deliver(done, self.recorders)

    def _resolve(self, wait: bool) -> tp.List[SpanRecord]:
        """The pending spans, oldest first, whose end event has passed (all of
        them with ``wait``); the caller holds the lock."""
        out = []
        while self.pending:
            path, start, host_s, ev0, ev1, thread = self.pending[0]
            device_s = None
            if ev0 is not None and ev1 is not None:
                if wait:
                    ev1.synchronize()
                elif not ev1.query():
                    break
                device_s = ev0.elapsed_time(ev1) * 1e-3
            self.free += [e for e in (ev0, ev1) if e is not None]
            self.pending.popleft()
            out.append(SpanRecord(path, start, host_s, device_s, thread))
        return out


_SPANS = _Spans()


def _deliver(done: tp.List[SpanRecord], recorders: tp.List[tp.List[SpanRecord]]) -> None:
    for rec in done:
        for out in list(recorders):
            out.append(rec)
        timings = [(rec.tag, rec.host_s)] if rec.device_s is None else \
            [(rec.tag, rec.device_s), (f"{rec.tag}.host", rec.host_s)]
        for tag, seconds in timings:
            ProfilerSink.add(tag, seconds)
            _to_server(tag, seconds)


class _Span:
    __slots__ = ("tag", "_range", "_start", "_ev0")

    def __init__(self, tag: str):
        self.tag = tag
        self._range = None

    def __enter__(self) -> "_Span":
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch._C._profiler._RecordFunctionFast(self.tag)
            self._range.__enter__()
            return self
        _SPANS.stack().append(self.tag)
        self._ev0 = _SPANS.event()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
            return False
        end = time.perf_counter()
        ev1 = _SPANS.event() if self._ev0 is not None else None
        stack = _SPANS.stack()
        path = tuple(stack)
        stack.pop()
        _SPANS.ended((path, self._start, end - self._start, self._ev0, ev1,
                      threading.get_ident()))
        return False


_OFF = contextlib.nullcontext()


def span(tag: str) -> tp.ContextManager:
    """``with span("tts.cfm"):`` marks the block (see the module docstring)."""
    if _model_on or _autograd_profiler._is_profiler_enabled:
        return _Span(tag)
    return _OFF


def flush_spans() -> None:
    """Resolve every ended span now, waiting for the end events still ahead on the
    device."""
    _SPANS.flush()


@contextlib.contextmanager
def record_spans() -> tp.Iterator[tp.List[SpanRecord]]:
    """The spans resolved while the block runs, every span that ended inside it
    among them (the block's end waits for them), in the order they resolved."""
    out: tp.List[SpanRecord] = []
    with _SPANS.lock:
        _SPANS.recorders.append(out)
    try:
        yield out
    finally:
        flush_spans()
        with _SPANS.lock:
            _SPANS.recorders.remove(out)
