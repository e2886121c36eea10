"""The port's ``DataProcessor`` (``speechflow_torch/data/core/processor.py``)
against the JAX package's, on the debug TTS data config over
``tests/data/SEGS``:

- a sample whose handler raises, whatever the exception, is dropped from its
  batch and the rest collate as JAX's batch does; with
  ``skip_corrupted_samples`` off both raise;
- under ``DATAPIPE_PROFILING=1`` each handler is timed as ``handler.<name>``,
  once a sample, as JAX's profiler times it; the port adds ``datapipe.sample``;
- a data worker's timings reach the experiment's ``LoggingServer``;
- ``Profiler`` and ``ProfilerSink`` against JAX's.

JAX's singletons are one instance per process and thread: every test that builds
a JAX pipeline clears them after itself.
"""

import dataclasses

import numpy as np
import pytest
import torch

from speechflow_torch.data.core.batch import Batch
from speechflow_torch.data.core.components import DataPipeline
from speechflow_torch.data.core.processor import DataProcessor
from speechflow_torch.logging.server import LoggingServer
from speechflow_torch.scripts.train_tts import configs
from speechflow_torch.utils.profiler import Profiler, ProfilerSink, profiling_enabled

torch.set_num_threads(1)
SEGS = "tests/data/SEGS"
N = 4  # samples in a batch; the second one fails


class _FailsOn:
    """A handler that raises ``exc`` on the sample at ``path`` and otherwise
    runs ``func`` (whose contract ``PipeRegistry.meta`` reads through ``func``)."""

    def __init__(self, func, path: str, exc: type):
        self.func, self.path, self.exc = func, path, exc

    def __call__(self, ds):
        if str(ds.file_path) == self.path:
            raise self.exc("a corrupt sample")
        return self.func(ds)


@pytest.fixture
def pipelines(monkeypatch):
    """(port pipeline, JAX subset component) of the debug data config."""
    from speechflow_tpu.data.core.components import DataPipeline as JDP
    from speechflow_tpu.data.core.singleton import Singleton
    from speechflow_tpu.io import Config

    monkeypatch.delenv("SFTPU_DUMP_CACHE", raising=False)
    monkeypatch.delenv("DATAPIPE_PROFILING", raising=False)
    _, data_cfg = configs("debug", data_root=SEGS)
    try:
        jdp = JDP(Config(data_cfg)).init_components()
        yield DataPipeline.from_config(data_cfg), jdp["train"]
    finally:
        Singleton.clear()


def _fields_equal(got, want) -> int:
    checked = 0
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            checked += 1
        elif f.name != "additional":
            assert (a is None) == (b is None), f.name
    return checked


@pytest.mark.parametrize("exc", [KeyError, IndexError, RuntimeError, ValueError])
def test_a_handler_that_raises_drops_its_sample_as_jax_does(pipelines, exc):
    """One sample of a batch raises ``exc`` in its first handler: both packages
    drop it and collate the other three alike (the port caught only ``OSError``
    and ``ValueError`` and raised the rest, stopping a run JAX carries on)."""
    ours, comp = pipelines
    mine = ours.datasets["train"][:N]
    theirs = list(comp.dataset)[:N]
    assert [s.file_path for s in mine] == [s.file_path for s in theirs]
    bad = str(mine[1].file_path)
    ours.preproc_fns[0] = _FailsOn(ours.preproc_fns[0], bad, exc)
    comp.data_processor.preproc_fns[0] = _FailsOn(comp.data_processor.preproc_fns[0], bad, exc)
    want = comp.data_processor.process([s.copy() for s in theirs])
    assert want.size == N - 1 and bad not in [str(s.file_path) for s in want.data_samples]
    got = ours.process.process([s.copy() for s in mine])
    assert isinstance(got, Batch) and got.size == N - 1
    assert [s.file_path for s in got.data_samples] == [s.file_path for s in want.data_samples]
    assert _fields_equal(got.collated_samples, want.collated_samples) >= 10
    assert _fields_equal(ours.process.batch(mine), want.collated_samples) >= 10


def test_with_skip_corrupted_samples_off_both_raise(pipelines):
    ours, comp = pipelines
    mine = ours.datasets["train"][:N]
    theirs = list(comp.dataset)[:N]
    bad = str(mine[1].file_path)
    fns = [_FailsOn(ours.preproc_fns[0], bad, KeyError), *ours.preproc_fns[1:]]
    strict = DataProcessor(fns, ours.collate_fn, ours.handler_params,
                           skip_corrupted_samples=False)
    comp.data_processor.skip_corrupted_samples = False
    comp.data_processor.preproc_fns[0] = _FailsOn(comp.data_processor.preproc_fns[0], bad,
                                                  KeyError)
    with pytest.raises(KeyError, match="corrupt"):
        comp.data_processor.process([s.copy() for s in theirs])
    with pytest.raises(KeyError, match="corrupt"):
        strict.process([s.copy() for s in mine])


def test_handlers_are_timed_under_datapipe_profiling_as_jax_times_them(pipelines,
                                                                        monkeypatch):
    from speechflow_tpu.utils.profiler import ProfilerSink as JSink

    ours, comp = pipelines
    mine = ours.datasets["train"][:N]
    theirs = list(comp.dataset)[:N]
    ProfilerSink.reset()
    JSink.reset()
    ours.process.process([s.copy() for s in mine])  # off: nothing timed
    assert ProfilerSink.summary() == {}
    monkeypatch.setenv("DATAPIPE_PROFILING", "1")
    assert profiling_enabled("DATAPIPE") and not profiling_enabled("MODEL")
    try:
        ours.process.process([s.copy() for s in mine])
        comp.data_processor.process([s.copy() for s in theirs])
        got, want = ProfilerSink.summary(), JSink.summary()
    finally:
        ProfilerSink.reset()
        JSink.reset()
    handlers = {f"handler.{n}" for n in ours.handler_names}
    assert set(want) == handlers and set(got) == handlers | {"datapipe.sample"}
    assert all(got[t]["count"] == want[t]["count"] == N for t in handlers)
    assert got["datapipe.sample"]["count"] == N


def test_a_workers_timings_reach_the_logging_server(tmp_path, monkeypatch):
    """The loader's worker process times its handlers and sends each timing to
    the experiment's ``LoggingServer``, which sums them up in its summary."""
    monkeypatch.setenv("DATAPIPE_PROFILING", "1")
    _, data_cfg = configs("debug", data_root=SEGS)
    pipeline = DataPipeline.from_config(data_cfg)
    ProfilerSink.reset()
    with LoggingServer(tmp_path / "experiment.log") as server:
        loader = pipeline.loader("train", 2, n_workers=1, prefetch_factor=1)
        try:
            batch = loader.next_batch()
        finally:
            loader.close()
    assert batch.mel.shape[0] == 2
    assert ProfilerSink.summary() == {}  # every handler ran in the worker
    counts = {t: len(v) for t, v in server.profiler_events.items()}
    n = counts["datapipe.sample"]
    assert n >= 2 and counts == {"datapipe.sample": n,
                                 **{f"handler.{h}": n for h in pipeline.handler_names}}
    text = (tmp_path / "experiment.log").read_text()
    assert "=== profiler summary ===" in text and f"datapipe.sample: n={n} " in text


def test_profiler_matches_jax():
    from speechflow_tpu.utils.profiler import Profiler as JProfiler
    from speechflow_tpu.utils.profiler import ProfilerSink as JSink

    ProfilerSink.reset()
    JSink.reset()
    try:
        for prof, sink in ((Profiler, ProfilerSink), (JProfiler, JSink)):
            for _ in range(3):
                with prof("stft") as p:
                    sum(range(1000))
                assert p.get_time() > 0
            with prof("off", enable=False):
                pass
            with prof(""):
                pass
            with prof("sync", device_sync=torch.ones(2) if prof is Profiler else None):
                pass
        got, want = ProfilerSink.summary(), JSink.summary()
        assert set(got) == set(want) == {"stft", "sync"}
        assert got["stft"]["count"] == want["stft"]["count"] == 3
        assert set(got["stft"]) == set(want["stft"]) == {"count", "total", "mean", "std"}
    finally:
        ProfilerSink.reset()
        JSink.reset()
