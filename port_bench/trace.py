"""The traced window: ``torch.profiler`` (CUPTI) over a short stretch of the
cell's own work, reduced in memory, from the profiler's raw events, to what the
per-layer metrics and the result's ``breakdown`` read.

- ``busy_s``: the union of the device's kernel, copy and fill intervals inside
  the window; ``window_s``: the window's length on the profiler's clock (a
  ``record_function`` range around work that starts and ends synchronised).
- ``kernel_s(names)``: device seconds of the kernels whose name contains one
  of ``names``.
- ``under_nodes_s(nodes)``: device seconds of the kernels launched by a host op
  that ran inside the backward of an autograd node of one of those names: the
  node's own range (``<node>Backward``, on the same thread), which holds the
  node's backward alone. The engine's ``evaluate_function`` range around it
  also holds the casts of its gradients to the inputs' dtypes and their sums
  into the gradients of inputs that other nodes share, and is not read.
- ``breakdown``: the ten device operations that took most time, and the idle
  gaps summed by the host op running in the middle of each.
"""

from __future__ import annotations

import bisect
import collections
import re
import time
import typing as tp

WINDOW = "port_bench.window"


def _short(name: str, width: int = 96) -> str:
    name = re.sub(r"^void ", "", name)
    return name if len(name) <= width else name[: width - 3] + "..."


def _union(intervals: tp.List[tp.Tuple[float, float]]) -> tp.List[tp.Tuple[float, float]]:
    out: tp.List[tp.List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """Device intervals (ns, the profiler's clock) with their names and the host
    op that launched each, the window, and the host ops."""

    def __init__(self, events, host_s: float):
        from torch.autograd import DeviceType

        self.host_s = host_s
        self.device: tp.List[tp.Tuple[str, int, int, int]] = []  # name, start, end, launcher
        self.cpu: tp.List[tp.Tuple[int, int, str, int, int]] = []  # start, end, name, id, thread
        window = None
        for e in events:
            name, dt = e.name(), e.device_type()
            if dt == DeviceType.CPU:
                if name == WINDOW:
                    window = window or (e.start_ns(), e.end_ns())
                    continue
                self.cpu.append((e.start_ns(), e.end_ns(), name, e.correlation_id(),
                                 e.start_thread_id()))
            elif dt == DeviceType.CUDA and name != WINDOW:  # the range's own mark left out
                self.device.append((name, e.start_ns(), e.end_ns(), e.linked_correlation_id()))
        self.cpu.sort()
        self._starts = [c[0] for c in self.cpu]
        if window is None:  # no range recorded: the span of what was traced
            times = [d[1] for d in self.device] + [d[2] for d in self.device]
            window = (min(times), max(times)) if times else (0, 0)
        self.window = window
        lo, hi = window
        self.busy = _union([(max(s, lo), min(e, hi)) for _, s, e, _ in self.device
                            if e > lo and s < hi])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def kernel_s(self, names: tp.Sequence[str]) -> float:
        return sum(e - s for n, s, e, _ in self.device if any(k in n for k in names)) * 1e-9

    def under_nodes_s(self, nodes: tp.Sequence[str]) -> float:
        targets = {n + "Backward" for n in nodes}
        ranges: tp.Dict[int, tp.List[tp.Tuple[int, int]]] = collections.defaultdict(list)
        for s, e, name, _, tid in self.cpu:
            if name in targets:
                ranges[tid].append((s, e))
        if not ranges:
            return 0.0
        starts = {tid: [r[0] for r in rs] for tid, rs in ranges.items()}
        inside = set()
        for s, e, _, cid, tid in self.cpu:
            rs = ranges.get(tid)
            if rs is None:
                continue
            i = bisect.bisect_right(starts[tid], s) - 1
            if i >= 0 and rs[i][0] <= s and e <= rs[i][1]:
                inside.add(cid)
        return sum(e - s for _, s, e, cid in self.device if cid in inside) * 1e-9

    def gaps(self) -> tp.List[tp.Tuple[int, int]]:
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def _host_label(self, t: float) -> str:
        """The host op running at time t that started last (the innermost one on
        its thread)."""
        i = bisect.bisect_right(self._starts, t)
        for s, e, name, _, _ in reversed(self.cpu[max(0, i - 5000):i]):
            if e >= t:
                return name
        return "host outside any op"

    def breakdown(self, top: int = 10) -> dict:
        ops: tp.Dict[str, float] = collections.Counter()
        for n, s, e, _ in self.device:
            ops[_short(n)] += (e - s) * 1e-9
        idle: tp.Dict[str, float] = collections.Counter()
        for s, e in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:100]:
            idle[_short(self._host_label(0.5 * (s + e)))] += (e - s) * 1e-9
        return {"device_ops": [[n, v] for n, v in ops.most_common(top)],
                "idle_gaps": [[n, v] for n, v in idle.most_common(top)]}


def profile(torch, fn: tp.Callable[[], None]) -> Trace:
    """Run ``fn`` (its work synchronised at both ends) under the profiler."""
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    return Trace(prof.profiler.kineto_results.events(), host_s)
