"""The program's spans in the traced window.

While ``torch.profiler`` records, each span of ``speechflow_torch``
(``utils/profiler.py::span``) is a range of its tag on the profiler's clock,
on the thread that opened it, with the scope of an operator: a host event of
the trace like ``aten::`` ops, with no mark of its own on the device's
timeline. A program without spans leaves none in the trace, and every
function here then reads nothing (0, or no entry).

- ``under_ranges_s(trace, tags)``: device seconds of the kernels, copies and
  fills launched by a host op inside a range of one of ``tags`` on the same
  thread (nested ranges of those tags count once). A device event names its op
  by the op's correlation id (``linked_correlation_id``); the CUDA API calls and
  the profiler's own marks carry ids of another count that collide with the
  ops', so they are left out of the search. With ``any_thread``, an op of any
  thread inside such a range counts: the autograd engine runs a backward's ops
  on a thread of its own while the span that called ``backward()`` waits on the
  caller's. On a trace with no such collision ``Trace.under_nodes_s(nodes)``
  reads as ``under_ranges_s(trace, [n + "Backward" for n in nodes])``.
- ``elapsed_in_ranges_s(trace, tags)``: for each such range (nested ones merged),
  its first launched kernel's start to its last one's end on the device, summed:
  the gaps between its kernels count.
- ``count(trace, tag)``: how many ranges of ``tag`` the trace holds.
- ``by_span(trace)``: the window's busy time by the innermost span open on the
  launching thread when each kernel was launched (on any thread where none is
  open on that one: the autograd engine's), a stretch of time run by kernels of
  several spans going to the one that started first; and its idle gaps by the
  innermost span open, on any thread, at each gap's midpoint; "outside any span"
  otherwise. Busy plus idle is the window.
- ``attention_bound_s(layer)`` and ``head_activation_bound_s(layer)``: the least
  time of the traced calls' attention and of their vocoder head's activations,
  as ``metrics/attention_roofline.serve.py`` and
  ``metrics/anti_alias_roofline.serve.py`` count them.
"""

from __future__ import annotations

import bisect
import collections
import typing as tp

from port_bench import roofline

# the tags of ``speechflow_torch``'s spans
TAGS = ("tts.inference", "tts.cfm", "vocoder.from_features", "vocoder.head",
        "op.attention", "op.attention.vjp", "op.aa_snake", "op.aa_upsample",
        "op.aa_snake_down", "op.aa_snake.vjp", "op.aa_upsample.vjp", "op.aa_snake_down.vjp",
        "gan.step", "gan.gen.forward", "gan.gen.loss", "gan.gen.backward", "gan.disc",
        "optim.step")
AA_FORWARD = ("op.aa_snake", "op.aa_upsample", "op.aa_snake_down")
AA_VJP = ("op.aa_snake.vjp", "op.aa_upsample.vjp", "op.aa_snake_down.vjp")
OUTSIDE = "outside any span"
# the profiler's own marks on the host, in the CUDA API calls' count of ids
PROFILER_MARKS = ("Command Buffer Full", "Activity Buffer Request", "Buffer Flush")


def is_op(name: str) -> bool:
    """Whether a host event of the trace is an op (``aten::``, an autograd node, a
    span, any ``record_function``) rather than a CUDA API call or a mark."""
    return not (name.startswith("cu") or name in PROFILER_MARKS)


def _merged(intervals: tp.List[tp.Tuple[int, int]]) -> tp.List[tp.Tuple[int, int]]:
    out: tp.List[tp.List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _launched_in(trace, tags: tp.Iterable[str], any_thread: bool = False
                 ) -> tp.Dict[int, tp.Tuple[int, int]]:
    """Correlation id of each host op inside a range of ``tags`` -> (thread,
    index of the merged range on that thread; thread None with ``any_thread``)."""
    tags = set(tags)
    by_thread: tp.Dict[int, tp.List[tp.Tuple[int, int]]] = collections.defaultdict(list)
    for s, e, name, _, tid in trace.cpu:
        if name in tags:
            by_thread[None if any_thread else tid].append((s, e))
    ranges = {tid: _merged(rs) for tid, rs in by_thread.items()}
    starts = {tid: [r[0] for r in rs] for tid, rs in ranges.items()}
    out = {}
    for s, e, name, cid, tid in trace.cpu:
        tid = None if any_thread else tid
        rs = ranges.get(tid)
        if rs is None or not is_op(name):
            continue
        i = bisect.bisect_right(starts[tid], s) - 1
        if i >= 0 and rs[i][0] <= s and e <= rs[i][1]:
            out[cid] = (tid, i)
    return out


def under_ranges_s(trace, tags: tp.Iterable[str], any_thread: bool = False) -> float:
    inside = _launched_in(trace, tags, any_thread)
    return sum(e - s for _, s, e, cid in trace.device if cid in inside) * 1e-9


def elapsed_in_ranges_s(trace, tags: tp.Iterable[str]) -> float:
    inside = _launched_in(trace, tags)
    first: tp.Dict[tp.Tuple[int, int], int] = {}
    last: tp.Dict[tp.Tuple[int, int], int] = {}
    for _, s, e, cid in trace.device:
        k = inside.get(cid)
        if k is not None:
            first[k] = min(first.get(k, s), s)
            last[k] = max(last.get(k, e), e)
    return sum(last[k] - first[k] for k in first) * 1e-9


def count(trace, tag: str) -> int:
    return sum(1 for c in trace.cpu if c[2] == tag)


class _Innermost:
    """The innermost span open at a time, on one thread or on any."""

    def __init__(self, trace):
        spans = sorted((s, e, name, tid) for s, e, name, _, tid in trace.cpu if name in TAGS)
        self.all = spans
        self.all_starts = [s[0] for s in spans]
        self.thread: tp.Dict[int, tp.List[tuple]] = collections.defaultdict(list)
        for sp in spans:
            self.thread[sp[3]].append(sp)
        self.thread_starts = {tid: [s[0] for s in v] for tid, v in self.thread.items()}

    @staticmethod
    def _find(spans, starts, t: float) -> str:
        for s, e, name, _ in reversed(spans[:bisect.bisect_right(starts, t)]):
            if e >= t:
                return name
        return OUTSIDE

    def on(self, tid: int, t: float) -> str:
        """On ``tid``, else on any thread."""
        if tid in self.thread:
            name = self._find(self.thread[tid], self.thread_starts[tid], t)
            if name != OUTSIDE:
                return name
        return self.anywhere(t)

    def anywhere(self, t: float) -> str:
        return self._find(self.all, self.all_starts, t)


def by_span(trace) -> dict:
    inner = _Innermost(trace)
    launcher = {cid: (tid, s) for s, _, name, cid, tid in trace.cpu if is_op(name)}
    lo, hi = trace.window
    busy: tp.Dict[str, float] = collections.Counter()
    covered = lo
    for _, s, e, cid in sorted(trace.device, key=lambda d: d[1]):
        s, e = max(s, lo, covered), min(e, hi)
        if e <= s:
            continue
        where = launcher.get(cid)
        busy[inner.on(*where) if where else OUTSIDE] += (e - s) * 1e-9
        covered = e
    idle: tp.Dict[str, float] = collections.Counter()
    for s, e in trace.gaps():
        idle[inner.anywhere(0.5 * (s + e))] += (e - s) * 1e-9
    return {"busy": [[n, v] for n, v in busy.most_common()],
            "idle": [[n, v] for n, v in idle.most_common()]}


def attention_bound_s(layer: dict) -> float:
    cfg = layer["config"]["acoustic_model"]
    dtype = layer["config"]["dtype"]
    enc_dh = cfg["encoder_dim"] // cfg["encoder_heads"]
    dec_dh = cfg["decoder_dim"] // cfg["decoder_heads"]
    cfg_x = 2 if cfg.get("cfm_cfg_scale", 0.0) > 0 else 1
    bound = 0.0
    for tokens, frames in layer["traced_calls"]:
        bound += cfg["encoder_layers"] * roofline.attention_bound_s(
            cfg["encoder_heads"], enc_dh, tokens, dtype)
        bound += cfg["cfm_n_timesteps"] * cfg["decoder_layers"] * roofline.attention_bound_s(
            cfg["decoder_heads"], dec_dh, list(frames) * cfg_x, dtype)
    return bound


def head_activation_bound_s(layer: dict) -> float:
    voc = layer["config"]["vocoder"]
    frames = sum(sum(f) for _, f in layer["traced_calls"])
    return roofline.head_activation_bound_s(
        frames, voc["upsample_rates"], voc["upsample_channels"],
        len(voc["resblock_kernel_sizes"]), 3, layer["config"]["dtype"])


def per_call_ms(layer: dict, tag: str) -> tp.Optional[float]:
    """Device ms of the kernels launched inside ``tag`` a range of it, in the trace."""
    tr = layer.get("trace")
    n = count(tr, tag) if tr is not None else 0
    s = under_ranges_s(tr, [tag]) if n else 0.0
    return 1e3 * s / n if s > 0 else None


def per_micro_batch_ms(layer: dict, tags: tp.Sequence[str], elapsed: bool = False
                       ) -> tp.Optional[float]:
    """Device ms a traced micro-batch of the kernels launched inside ``tags`` on
    any thread (with ``elapsed``: each range's first kernel to its last, on the
    range's own thread)."""
    tr, n = layer.get("trace"), layer.get("micro_batches")
    if tr is None or not n:
        return None
    s = elapsed_in_ranges_s(tr, tags) if elapsed else under_ranges_s(tr, tags, True)
    return 1e3 * s / n if s > 0 else None


def roofline_share(layer: dict, bound: tp.Callable[[dict], float],
                   tags: tp.Sequence[str]) -> tp.Optional[float]:
    """100 x ``bound(layer)`` over the device time launched inside ``tags``."""
    tr = layer.get("trace")
    if tr is None or not layer.get("traced_calls"):
        return None
    device_s = under_ranges_s(tr, tags)
    return 100.0 * bound(layer) / device_s if device_s > 0 else None
