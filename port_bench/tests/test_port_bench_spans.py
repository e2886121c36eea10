"""The readers of the program's spans (``port_bench/spans.py`` and the metrics
that use it) on synthetic traces: a training-like one, where the autograd
engine's thread runs the backward under a span of the caller's, and a
serving-like one of two calls. Times are nanoseconds on the profiler's clock.
As in the profiler's own traces, a device event links to the op that launched
it, and a CUDA API call may carry the same id as an op elsewhere."""

import pytest
from torch.autograd import DeviceType

import debug_cells  # noqa: F401  (puts the repository on the path)
from port_bench import core, spans
from port_bench import trace as T

MAIN, ENGINE = 1, 2


class _Ev:
    """What ``Trace`` reads of one of the profiler's events."""

    def __init__(self, name, start, end, tid=MAIN, cid=0, linked=0, device=False):
        self._v = (name, start, end, tid, cid, linked, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def device_type(self):
        return DeviceType.CUDA if self._v[6] else DeviceType.CPU


def _launch(cid, at, kernel, start, end, tid=MAIN):
    """An op at ``at`` (and its CUDA call, whose id is of another count) and the
    device interval it started."""
    return [_Ev("aten::op", at, at + 5, tid, cid), _Ev("cudaLaunchKernel", at + 1, at + 4, tid, 0),
            _Ev(kernel, start, end, 0, 1000 + cid, cid, device=True)]


def _training_trace(with_spans: bool = True, collide: bool = False) -> T.Trace:
    ev = [_Ev(T.WINDOW, 0, 1000, cid=1)]
    ev += _launch(11, 40, "aa_kernel", 50, 150)
    ev += [_Ev("_AntiAliasSnakeFnBackward", 310, 500, ENGINE, 5)]
    ev += _launch(21, 320, "elementwise_kernel", 330, 380, ENGINE)
    ev += _launch(22, 400, "elementwise_kernel", 420, 470, ENGINE)
    ev += _launch(23, 520, "dgrad_engine", 530, 580, ENGINE)  # a backward op outside the VJPs
    ev += _launch(31, 710, "multi_tensor_apply", 720, 760)
    if collide:  # a CUDA call in the VJP whose id is the optimizer's op's
        ev += [_Ev("cudaMemsetAsync", 410, 412, ENGINE, 31)]
    if with_spans:
        ev += [_Ev("gan.step", 10, 850, cid=2), _Ev("gan.gen.forward", 20, 200, cid=3),
               _Ev("op.aa_snake", 30, 60, cid=4), _Ev("gan.gen.backward", 300, 600, cid=6),
               _Ev("op.aa_snake.vjp", 315, 495, ENGINE, 7), _Ev("optim.step", 700, 800, cid=8)]
    return T.Trace(ev, host_s=1e-6)


def _layer(tr, **kw):
    return dict({"trace": tr, "micro_batches": 1}, **kw)


NODES = ("_AntiAliasSnakeFn", "_UpsampleFirFn", "_SnakeDownsampleFn")


def test_under_ranges_reads_as_under_nodes():
    tr = _training_trace()
    got = spans.under_ranges_s(tr, [n + "Backward" for n in NODES])
    assert got == tr.under_nodes_s(NODES) == pytest.approx(100e-9)


def test_a_cuda_calls_id_names_no_op():
    """The accepted reader counts the optimizer's kernel in the VJP through the
    CUDA call's colliding id; the spans' readers do not."""
    tr = _training_trace(collide=True)
    assert tr.under_nodes_s(NODES) == pytest.approx(140e-9)
    assert spans.under_ranges_s(tr, [n + "Backward" for n in NODES]) == pytest.approx(100e-9)
    assert spans.elapsed_in_ranges_s(tr, spans.AA_VJP) == pytest.approx(140e-9)
    assert dict(spans.by_span(tr)["busy"])["optim.step"] == pytest.approx(40e-9)


def test_ranges_on_their_thread_and_on_any():
    tr = _training_trace()
    assert spans.under_ranges_s(tr, ["gan.gen.backward"]) == 0.0  # the engine launched them
    assert spans.under_ranges_s(tr, ["gan.gen.backward"], any_thread=True) == \
        pytest.approx(150e-9)
    assert spans.under_ranges_s(tr, spans.AA_VJP) == pytest.approx(100e-9)
    assert spans.elapsed_in_ranges_s(tr, spans.AA_VJP) == pytest.approx(140e-9)
    # nested ranges of the tags asked for count once
    assert spans.under_ranges_s(tr, ["gan.step", "gan.gen.forward", "op.aa_snake"]) == \
        pytest.approx(140e-9)
    assert spans.count(tr, "gan.step") == 1 and spans.count(tr, "tts.cfm") == 0


def test_by_span_splits_the_window():
    tr = _training_trace()
    got = spans.by_span(tr)
    busy, idle = dict(got["busy"]), dict(got["idle"])
    assert busy == pytest.approx({"op.aa_snake": 100e-9, "op.aa_snake.vjp": 100e-9,
                                  "gan.gen.backward": 50e-9, "optim.step": 40e-9})
    # gaps [0,50] [150,330] [380,420] [470,530] [580,720] [760,1000] at their midpoints
    assert idle == pytest.approx({"gan.gen.forward": 50e-9, "gan.step": 180e-9 + 140e-9,
                                  "op.aa_snake.vjp": 40e-9, "gan.gen.backward": 60e-9,
                                  spans.OUTSIDE: 240e-9})
    assert sum(busy.values()) == pytest.approx(tr.busy_s)
    assert sum(busy.values()) + sum(idle.values()) == pytest.approx(tr.window_s)


def test_by_span_of_overlapping_kernels_and_no_spans():
    ev = [_Ev(T.WINDOW, 0, 100, cid=1), _Ev("tts.cfm", 0, 50, cid=2)]
    ev += _launch(3, 1, "a", 10, 40) + _launch(4, 2, "b", 20, 60) + _launch(5, 60, "c", 70, 120)
    tr = T.Trace(ev, host_s=1e-6)
    got = spans.by_span(tr)
    assert dict(got["busy"]) == pytest.approx({"tts.cfm": 50e-9, spans.OUTSIDE: 30e-9})
    total = sum(v for _, v in got["busy"] + got["idle"])
    assert total == pytest.approx(tr.window_s)
    bare = _training_trace(with_spans=False)
    got = spans.by_span(bare)
    assert [n for n, _ in got["busy"] + got["idle"]] == [spans.OUTSIDE, spans.OUTSIDE]


TRAIN = {"gen_forward_ms.train": 100e-6, "gen_loss_ms.train": None,
         "gen_backward_ms.train": 150e-6, "disc_ms.train": None,
         "optimizer_ms.train": 40e-6, "anti_alias_vjp_span_ms.train": 140e-6}


def _reader(name):
    return core.load_file(core.HERE / "metrics" / f"{name}.py", f"span_reader_{name}")


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_training_readers(name):
    want = TRAIN[name]
    got = _reader(name).read(_layer(_training_trace(), micro_batches=2))
    assert got is None if want is None else got == pytest.approx(want / 2)
    assert _reader(name).read(_layer(_training_trace(with_spans=False))) is None


def _serving_trace(with_spans: bool = True):
    """Two calls: each an attention kernel inside ``op.attention`` in ``tts.cfm``,
    and a fused anti-alias kernel inside ``op.aa_snake`` in ``vocoder.head``."""
    ev = [_Ev(T.WINDOW, 0, 2000, cid=1)]
    for i, t0 in enumerate((0, 1000)):
        c = 10 * (i + 1)
        ev += _launch(c + 1, t0 + 20, "attn_fwd_kernel", t0 + 30, t0 + 230)
        ev += _launch(c + 2, t0 + 300, "aa_kernel", t0 + 310, t0 + 710)
        ev += _launch(c + 3, t0 + 800, "elementwise_kernel", t0 + 810, t0 + 910)
        if with_spans:
            ev += [_Ev("tts.cfm", t0 + 10, t0 + 250, cid=c + 4),
                   _Ev("op.attention", t0 + 15, t0 + 240, cid=c + 5),
                   _Ev("vocoder.head", t0 + 290, t0 + 900, cid=c + 6),
                   _Ev("op.aa_snake", t0 + 295, t0 + 320, cid=c + 7)]
    return T.Trace(ev, host_s=1e-6)


@pytest.fixture(scope="module")
def serve_layer():
    cell = core.Cell.load("cfm-bigvgan.b32-long")
    calls = [([128] * 32, [972] * 32), ([120] * 32, [960] * 32)]
    return {"config": cell.config, "hop": 256, "traced_calls": calls}


def test_serving_readers(serve_layer):
    layer = dict(serve_layer, trace=_serving_trace())
    assert _reader("cfm_ms.serve").read(layer) == pytest.approx(200e-6)
    assert _reader("vocoder_head_ms.serve").read(layer) == pytest.approx(500e-6)
    # where the spans hold the very kernels the accepted readers name, they read alike
    for op, named in (("attention_op_roofline.serve", "attention_roofline.serve"),
                      ("anti_alias_op_roofline.serve", "anti_alias_roofline.serve")):
        assert _reader(op).read(layer) == pytest.approx(_reader(named).read(layer))
    bare = dict(serve_layer, trace=_serving_trace(with_spans=False))
    for name in ("cfm_ms.serve", "vocoder_head_ms.serve", "attention_op_roofline.serve",
                 "anti_alias_op_roofline.serve"):
        assert _reader(name).read(bare) is None


def test_new_metrics_are_declared_with_their_cells():
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    serve = ["cfm-bigvgan.b32-long", "cfm-bigvgan.b32-sentences"]
    for name in ("cfm_ms.serve", "vocoder_head_ms.serve", "attention_op_roofline.serve",
                 "anti_alias_op_roofline.serve"):
        assert per_layer[name]["workloads"] == serve
    for name in TRAIN:
        assert per_layer[name]["workloads"] == ["bigvgan-gan.b32-1s"]


def test_the_span_reports_window():
    """``span_report`` keeps the spans of the window's calls: from the call that
    starts nearest to the window's start, read to ~10 ms, for ``attempted`` calls."""
    from port_bench import span_report
    from speechflow_torch.utils.profiler import SpanRecord

    recs = []
    for i in range(6):  # calls of 1 s from t = 0, the window's from t = 2
        recs += [SpanRecord(("gan.step",), float(i), 0.9, 0.8, 1),
                 SpanRecord(("gan.step", "gan.gen.forward"), i + 0.001, 0.1, 0.1, 1)]
    for start in (1.99, 2.0, 2.01):
        got = span_report.window_records(recs, "gan.step", start, 3)
        assert sorted(r.start for r in got) == [2.0, 2.001, 3.0, 3.001, 4.0, 4.001]
    summary = span_report.summarise(span_report.window_records(recs, "gan.step", 2.0, 3), 3)
    assert summary["gan.step"] == pytest.approx(
        {"n": 3, "device_ms": 2400.0, "host_ms": 2700.0, "device_ms_each": 800.0,
         "host_ms_each": 900.0})
    assert len(span_report.window_records(recs, "gan.step", 4.0, 5)) == 4  # to the end
