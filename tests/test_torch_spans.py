"""Model spans (``speechflow_torch/utils/profiler.py::span``) on the CPU:

- off, with no ``torch.profiler`` recording, a span enters no profiler range and
  creates no CUDA event;
- on, one ``GANTrainer.training_step`` of the debug vocoder recipe emits its tag
  tree in order, with parents; ``ParallelTTSModel.inference`` emits ``tts.cfm``
  inside ``tts.inference``, and ``Vocos.from_features`` emits ``vocoder.head``;
- the kernels' autograd Functions emit their entry and VJP spans;
- resolved spans reach ``ProfilerSink.summary()`` and a ``LoggingServer``'s
  profiler summary;
- with CUDA events (a stand-in class here), a span never waits for the device:
  it is resolved once its end event has passed, or when read; while the stream
  captures a CUDA graph it records no event;
- while ``torch.profiler`` records, a span is a range on its clock, of an
  operator's scope (no mark of its own on the device's timeline), and joins no
  record.
"""

import numpy as np
import pytest
import torch

from speechflow_torch import serving
from speechflow_torch.logging.server import LoggingServer
from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams
from speechflow_torch.models.vocoder import Vocos, VocosParams
from speechflow_torch.models.vocoder.batch_processor import VocoderBatchProcessor
from speechflow_torch.models.vocoder.criterion import (
    vocoder_disc_criterion,
    vocoder_gen_criterion,
)
from speechflow_torch.models.vocoder.discriminators import VocoderDiscriminator
from speechflow_torch.ops import anti_alias as AA
from speechflow_torch.ops import attention as A
from speechflow_torch.scripts.train_vocoder import configs
from speechflow_torch.training.gan_trainer import GANTrainer
from speechflow_torch.training.optimizer import OptimizerConfig
from speechflow_torch.training.trainer import TrainerConfig
from speechflow_torch.utils import profiler as P

torch.set_num_threads(1)
USER_SCOPE = 7  # at::RecordScope::USER_SCOPE, record_function's


@pytest.fixture
def spans_on():
    was = P.set_model_profiling(True)
    P.ProfilerSink.reset()
    try:
        yield
    finally:
        P.flush_spans()
        P.set_model_profiling(was)
        P.ProfilerSink.reset()


@pytest.fixture(scope="module")
def gan():
    model_cfg, _ = configs("debug")
    opt = OptimizerConfig.from_config(dict(model_cfg["optimizer"], grad_accum=1))
    torch.manual_seed(0)
    return GANTrainer(Vocos(VocosParams.create(model_cfg["model"])),
                      VocoderDiscriminator(**model_cfg["discriminator"]),
                      vocoder_gen_criterion(n_mels=model_cfg["model"]["n_mels"],
                                            **dict(model_cfg["loss"], adv_start_iter=0)),
                      vocoder_disc_criterion(), VocoderBatchProcessor(),
                      gen_optimizer=opt, disc_optimizer=opt,
                      config=TrainerConfig(max_steps=10))


def _batch(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"waveform": (0.1 * rng.standard_normal((2, 4096))).astype(np.float32)}


@pytest.fixture(scope="module")
def serving_pair():
    tts = dict(serving.TTS_MODEL_PRESETS["debug"], **serving.FLAGSHIP_OVERRIDES["tts"])
    tts.update(decoder_type="cfm", cfm_n_timesteps=2, max_output_length=64)
    voc = dict(serving.VOCODER_BIGVGAN_PRESETS["debug"], **serving.FLAGSHIP_OVERRIDES["vocoder"])
    torch.manual_seed(0)
    am = ParallelTTSModel(ParallelTTSParams.create(tts)).eval()
    vm = Vocos(VocosParams.create(voc)).eval()
    inputs = serving.bench_inputs(np.random.default_rng(0), batch=2, n_tokens=8, t_frames=64)
    return am, vm, inputs


def _tree(records):
    return [(r.tag, r.parent) for r in sorted(records, key=lambda r: r.start)]


def _raise(*args, **kwargs):
    raise AssertionError("entered while spans are off")


def test_off_enters_no_range_and_creates_no_event(monkeypatch, gan, serving_pair):
    was = P.set_model_profiling(False)
    try:
        # torch's optimizers enter ``record_function`` of their own in every step,
        # so the spans' range and span object are what must not be made
        for mod, name in ((torch._C._profiler, "_RecordFunctionFast"), (P, "_Span"),
                          (torch.cuda, "Event")):
            monkeypatch.setattr(mod, name, _raise)
        P.ProfilerSink.reset()
        with P.record_spans() as got:
            gan.training_step(_batch())
            am, vm, inputs = serving_pair
            with torch.no_grad():
                serving.synthesize(am, vm, inputs, t_out=64)
        assert got == [] and P.ProfilerSink.summary() == {}
        assert P.span("x") is P.span("y")  # one shared no-op context
    finally:
        P.set_model_profiling(was)


def test_gan_step_emits_its_tag_tree(spans_on, gan):
    with P.record_spans() as got:
        gan.training_step(_batch(1))
    assert _tree(got) == [
        ("gan.step", None),
        ("gan.gen.forward", "gan.step"),
        ("vocoder.from_features", "gan.gen.forward"),
        ("vocoder.head", "vocoder.from_features"),
        ("gan.gen.loss", "gan.step"),
        ("gan.gen.backward", "gan.step"),
        ("optim.step", "gan.step"),
        ("gan.disc", "gan.step"),
        ("optim.step", "gan.step"),
    ]
    step = next(r for r in got if r.tag == "gan.step")
    assert step.path == ("gan.step",) and step.device_s is None
    inner = [r for r in got if r.tag != "gan.step"]
    assert all(step.start <= r.start and r.start + r.host_s <= step.start + step.host_s
               for r in inner)
    # children end before their parents, so they resolve first
    assert got[-1].tag == "gan.step"


def test_inference_and_vocoder_spans(spans_on, serving_pair):
    am, vm, inputs = serving_pair
    with P.record_spans() as got, torch.no_grad():
        serving.synthesize(am, vm, inputs, t_out=64)
    assert _tree(got) == [
        ("tts.inference", None),
        ("tts.cfm", "tts.inference"),
        ("vocoder.from_features", None),
        ("vocoder.head", "vocoder.from_features"),
    ]


def _plain_launches(monkeypatch):
    """The kernels' launches as their plain versions, so that the autograd
    Functions (the CUDA path) run on CPU tensors."""
    monkeypatch.setattr(AA, "_launch_fused", lambda x, a, b, taps:
                        AA.anti_alias_snake_reference(x, a, b, taps))
    monkeypatch.setattr(AA, "_launch_upsample", lambda x, taps:
                        AA.aa_upsample_fir_reference(x, taps))
    monkeypatch.setattr(AA, "_launch_downsample", lambda ye, yo, a, b, taps:
                        AA.aa_snake_downsample_reference(ye, yo, a, b, taps))
    monkeypatch.setattr(A, "_launch", lambda q, k, v, valid:
                        A.attention_reference(q, k, v, valid))


def test_kernel_functions_emit_entry_and_vjp_spans(spans_on, monkeypatch):
    _plain_launches(monkeypatch)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 32, 4, generator=g, requires_grad=True)
    alpha = torch.zeros(4, requires_grad=True)
    beta = torch.zeros(4, requires_grad=True)
    q = torch.randn(2, 8, 2, 4, generator=g, requires_grad=True)
    valid = torch.ones(2, 8, dtype=torch.bool)
    with P.record_spans() as fwd:
        with P.span("outer"):
            y = AA._AntiAliasSnakeFn.apply(x, alpha, beta, 12)
            ye, yo = AA._UpsampleFirFn.apply(x, 12)
            z = AA._SnakeDownsampleFn.apply(ye, yo, alpha, beta, 12)
            o = A._FusedAttentionFn.apply(q, q, q, valid)
    assert _tree(fwd) == [("outer", None), ("op.aa_snake", "outer"),
                          ("op.aa_upsample", "outer"), ("op.aa_snake_down", "outer"),
                          ("op.attention", "outer")]
    with P.record_spans() as bwd:
        (y.sum() + z.sum() + o.sum()).backward()
    # the CPU engine runs the backward in this thread, with no span open
    assert sorted(_tree(bwd)) == sorted([
        ("op.aa_snake.vjp", None), ("op.aa_upsample.vjp", None),
        ("op.aa_snake_down.vjp", None), ("op.attention.vjp", None)])


def test_spans_reach_the_sink_and_the_logging_server(spans_on, tmp_path):
    log = tmp_path / "experiment.log"
    with LoggingServer(log):
        for _ in range(3):
            with P.span("model.part"):
                with P.span("model.part.inner"):
                    pass
    summary = P.ProfilerSink.summary()
    assert summary["model.part"]["count"] == 3 and summary["model.part.inner"]["count"] == 3
    text = log.read_text()
    assert "=== profiler summary ===" in text
    assert "model.part: n=3 " in text and "model.part.inner: n=3 " in text


class _FakeEvent:
    """A CUDA event stand-in: passes once ``ready`` says so; counts waits."""
    made = 0
    waits = 0
    ready = False
    clock = 0.0

    def __init__(self, enable_timing: bool = False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self):
        _FakeEvent.clock += 1.0
        self.t = _FakeEvent.clock

    def query(self) -> bool:
        return _FakeEvent.ready

    def synchronize(self):
        _FakeEvent.waits += 1

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3  # ms


@pytest.fixture
def fake_cuda(monkeypatch):
    for k, v in (("made", 0), ("waits", 0), ("ready", False), ("clock", 0.0)):
        setattr(_FakeEvent, k, v)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    return monkeypatch


def test_event_spans_resolve_without_waiting(spans_on, fake_cuda):
    with P.record_spans() as got:
        with P.span("a"):
            with P.span("b"):
                pass
        assert got == [] and _FakeEvent.waits == 0  # both still ahead on the "device"
        _FakeEvent.ready = True
        with P.span("c"):  # its end resolves every span whose end event has passed
            pass
        assert [r.tag for r in got] == ["b", "a", "c"] and _FakeEvent.waits == 0
    # b: events 2 and 3; a: 1 and 4 (one clock tick an event)
    assert [r.device_s for r in got] == [1.0, 3.0, 1.0]
    assert got[1].path == ("a",) and got[0].path == ("a", "b")
    made = _FakeEvent.made
    with P.span("d"):
        pass
    assert _FakeEvent.made == made  # resolved spans' events are used again
    _FakeEvent.ready = False
    with P.span("e"):
        pass
    summary = P.ProfilerSink.summary()  # a read waits for "e"
    assert _FakeEvent.waits == 1
    assert summary["a"]["total"] == 3.0 and summary["e"]["count"] == 1
    assert summary["a.host"]["count"] == 1 and summary["a.host"]["total"] < 1.0


def test_no_event_while_capturing_a_graph(spans_on, fake_cuda):
    fake_cuda.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    fake_cuda.setattr(torch.cuda, "Event", _raise)
    with P.record_spans() as got:
        with P.span("captured"):
            pass
    assert [(r.tag, r.device_s) for r in got] == [("captured", None)]
    assert P.ProfilerSink.summary()["captured"]["count"] == 1


@pytest.mark.parametrize("model_profiling", [False, True])
def test_spans_are_operator_ranges_under_the_profiler(model_profiling, monkeypatch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    was = P.set_model_profiling(model_profiling)
    for mod, name in ((torch.cuda, "Event"), (torch.autograd.profiler, "record_function"),
                      (torch.profiler, "record_function")):
        monkeypatch.setattr(mod, name, _raise)
    try:
        with P.record_spans() as got:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with P.span("outer.part"):
                    with P.span("inner.part"):
                        torch.ones(4).sum()
    finally:
        P.set_model_profiling(was)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("outer.part", "inner.part")}
    assert set(events) == {"outer.part", "inner.part"} and got == []
    outer, inner = events["outer.part"], events["inner.part"]
    assert all(e.device_type() == DeviceType.CPU and e.scope() != USER_SCOPE
               for e in events.values())
    assert outer.start_ns() <= inner.start_ns() and inner.end_ns() <= outer.end_ns()
