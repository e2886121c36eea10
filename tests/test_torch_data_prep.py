"""The data-preparation chain of the port against the JAX package's, over a copy
of ``tests/data/SEGS`` (the debug data config: 6 utterances a subset):

- ``dump``: ``ranges.json`` (1e-6 relative; in practice equal), the report, the
  per-word contours (equal), the prosody centroids' inertia (at most sklearn's
  ``KMeans(n_init=4, random_state=0)`` x 1.001) and, on well separated data,
  the same centroids as sklearn (1e-5 of their scale);
- the feature cache: the port reads a dump directory JAX wrote (every handler a
  hit, the same samples as its own run), refuses a pickled JAX class it has no
  counterpart of by name, and keeps what the contour handlers change in place
  (JAX's cache does not: ROADMAP §3);
- ``prosody_annotation``: the same ``prosody`` tiers as JAX's from the same
  centroids;
- ``data_pipeline_check``: JAX's report lines;
- ``eval_tts`` over ``tests/data/jax_checkpoints``: JAX's mel within 2e-5 of its
  scale (``chip_smoke.py``'s ``TOL_JAX_MEL``), and a waveform file;
- the pipeline that normalises pitch and energy by speaker from ``ranges.json``
  (``tests/test_signal1d.py``'s): JAX's collated batch, averages included.
"""

import copy
import json
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from speechflow_torch.data.core.components import DataPipeline
from speechflow_torch.data.core.processor import DumpProcessor
from speechflow_torch.scripts import data_pipeline_check, dump, eval_tts, prosody_annotation
from speechflow_torch.scripts.train_tts import configs
from speechflow_torch.training.saver import UnmappedClassError

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
SEGS = REPO / "tests" / "data" / "SEGS"
CFG = REPO / "configs" / "tts_data_24khz.yml"
FIXTURE = REPO / "tests" / "data" / "jax_checkpoints"
CONTOUR_PIPE = {  # tests/test_signal1d.py's contour handlers, before aggregate_pitch
    "signal_enhancement": {"attributes": "pitch", "interpolate_zeros": True, "smooth": True},
    "average_by_time": {"attributes": ["pitch", "energy", "rate"], "use_quantile": True},
    "normalize": {"attributes": ["pitch", "energy"], "normalize_by": "speaker"},
}


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Each package's dump of the debug config over its own copy of SEGS."""
    from speechflow_tpu.scripts import dump as jdump

    root = tmp_path_factory.mktemp("dumps")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SFTPU_DUMP_CACHE", raising=False)
        for name, main in (("jax", jdump.main), ("port", dump.main)):
            data = root / f"segs_{name}"
            shutil.copytree(SEGS, data)
            report = main(["-cd", str(CFG), "-vs", "debug", "--dump_path",
                           str(root / f"dump_{name}"), "--data_root", str(data)])
            out[name] = dict(report=report, dump=root / f"dump_{name}", data=data)
    return out


def _samples(dump_cfg: dict):
    """Every sample of the port's pipeline of ``dump_cfg``, processed, and the
    pipeline's cache."""
    dp = DataPipeline.from_config(dump_cfg)
    proc = dp.process
    return [proc.sample(d) for s in dp.info["subsets"] for d in dp.datasets[s]], proc.dump


def _jax_samples(cfg: dict):
    from speechflow_tpu.data.core.components import DataPipeline as JDP
    from speechflow_tpu.io import Config

    jdp = JDP(Config(copy.deepcopy(cfg))).init_components()
    return [jdp[s].data_processor.process_sample(jdp[s].dataset[i].copy())
            for s in jdp.subsets for i in range(len(jdp[s].dataset))]


def test_dump_ranges_and_report_match_jax(dumps):
    ours = json.loads((dumps["port"]["dump"] / "ranges.json").read_text())
    ref = json.loads((dumps["jax"]["dump"] / "ranges.json").read_text())
    assert set(ours) == set(ref) == {"LJSpeech", "p225"}
    for spk in ref:
        assert set(ours[spk]) == set(ref[spk]) == {"pitch", "energy", "aggregate_pitch",
                                                   "aggregate_energy"}
        for feat, v in ref[spk].items():
            np.testing.assert_allclose(ours[spk][feat], v, rtol=1e-6, atol=0)
    assert json.loads((dumps["port"]["dump"] / "dump_report.json").read_text()) == \
        json.loads((dumps["jax"]["dump"] / "dump_report.json").read_text())
    report = dumps["port"]["report"]
    assert report["cache_hits"] == 0 and len(report["sample_ms"]) == 12


def test_contours_equal_jax_and_centroids_beat_sklearn(dumps):
    from sklearn.cluster import KMeans

    from speechflow_tpu.scripts import dump as jdump

    samples, _ = _samples(dump.dump_config(CFG, ["debug"], dumps["port"]["dump"],
                                           dumps["port"]["data"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SFTPU_DUMP_CACHE", raising=False)
        _, cfg = configs("debug", data_root=dumps["jax"]["data"])
        jsamples = _jax_samples(cfg)
    contours = dump.extract_pitch_contours(samples)
    ref = jdump.extract_pitch_contours(jsamples)
    assert contours.shape == ref.shape and len(contours) > 100
    np.testing.assert_array_equal(contours, ref)

    cents = np.load(dumps["port"]["dump"] / "prosody_centroids.npy")
    np.testing.assert_array_equal(cents, dump.cluster_contours(contours))
    km = KMeans(n_clusters=8, n_init=4, random_state=0).fit(contours)
    inertia = float(dump._sq_dist(contours.astype(np.float64), cents).min(1).sum())
    assert cents.shape == (8, 10) and inertia <= km.inertia_ * 1.001


def test_kmeans_finds_sklearn_centroids_on_separated_data():
    from sklearn.cluster import KMeans

    rng = np.random.default_rng(3)
    centers = rng.uniform(-10, 10, (8, 10))
    x = np.concatenate([c + 0.05 * rng.standard_normal((60, 10)) for c in centers])
    ours, inertia = dump.kmeans(x, 8, n_init=4, seed=0)
    ref = KMeans(n_clusters=8, n_init=4, random_state=0).fit(x)
    match = dump._sq_dist(ref.cluster_centers_, ours)
    assert sorted(np.argmin(match, axis=1)) == list(range(8))
    np.testing.assert_allclose(ours[np.argmin(match, axis=1)], ref.cluster_centers_,
                               atol=1e-5 * np.abs(centers).max())
    assert inertia == pytest.approx(ref.inertia_, rel=1e-6)


def test_port_reads_a_jax_dump_directory(dumps):
    """The JAX dump's ``.pkl`` cache (its ``AudioChunk`` and ``Timestamps``
    pickled) serves every handler of the port's pipeline: the samples equal the
    port's own uncached run."""
    from tests.test_torch_handlers import assert_same_sample

    # a cache file is named by its sample's path: read the JAX copy of SEGS
    jax_cfg = dump.dump_config(CFG, ["debug"], dumps["jax"]["dump"], dumps["jax"]["data"])
    assert len(list(dumps["jax"]["dump"].glob("*.pkl"))) == 12
    cached, cache = _samples(jax_cfg)
    assert cache.misses == 0 and cache.hits == 12 * 18
    _, cfg = configs("debug", data_root=dumps["jax"]["data"])
    fresh, _ = _samples(cfg | {"processor": {}})
    for a, b in zip(cached, fresh):
        assert_same_sample(a, b)


def test_unmapped_jax_class_in_a_dump_is_refused(tmp_path):
    # a class of the JAX package the port leaves out (tests/test_torch_api_coverage.py::
    # LEFT_OUT); JAX's ``Batch`` and then ``ComponentState`` served here until the port
    # gained its own
    from speechflow_tpu.logging.server import ZMQPushHandler

    cache = DumpProcessor(tmp_path, full_dump=True)
    ds = type("S", (), {"file_path": "x.TextGridStage3", "uid": "u"})()
    cache.file_for(ds).write_bytes(pickle.dumps({"load_audio|0": {"b": ZMQPushHandler}}))
    with pytest.raises(UnmappedClassError,
                       match="speechflow_tpu.logging.server.ZMQPushHandler"):
        cache.load(ds)
    cache.file_for(ds).write_bytes(b"\x80\x05truncated")
    assert cache.load(ds) == {}


def _contour_cfg(data_root, dump_path=None) -> dict:
    _, cfg = configs("debug", data_root=data_root)
    pipe = cfg["preproc"]["pipe"]
    i = pipe.index("aggregate_pitch")
    pipe[i:i] = list(CONTOUR_PIPE)
    cfg["preproc"]["pipe_cfg"].update(copy.deepcopy(CONTOUR_PIPE))
    cfg["dataset"]["max_num_samples"] = 2
    if dump_path is not None:
        cfg["processor"] = {"dump": {"dump_path": str(dump_path), "full_dump": True}}
    return cfg


def test_cached_pass_keeps_contour_handlers(tmp_path, monkeypatch):
    """ROADMAP §3: a contour handler changes pitch in place and declares it only
    optional. JAX's cache stores nothing for it, so JAX's cached pass gives the
    pitch before the enhancement; the port's cached pass equals its first."""
    from tests.test_torch_handlers import assert_same_sample

    monkeypatch.delenv("SFTPU_DUMP_CACHE", raising=False)
    cfg = _contour_cfg(SEGS, tmp_path / "jax")
    first, cached = _jax_samples(cfg), _jax_samples(cfg)
    raw = _jax_samples(_contour_cfg(SEGS) | {"preproc": configs("debug")[1]["preproc"]})
    assert not np.array_equal(first[0].pitch, cached[0].pitch)
    np.testing.assert_array_equal(cached[0].pitch, raw[0].pitch)

    cfg = _contour_cfg(SEGS, tmp_path / "port")
    ours_first, _ = _samples(cfg)
    ours_cached, cache = _samples(cfg)
    assert cache.misses == 0
    for a, b, j in zip(ours_cached, ours_first, first):
        assert_same_sample(a, b)
        assert_same_sample(b, j)


def test_prosody_annotation_writes_jax_s_tiers(dumps):
    """From the JAX dump's centroids (copied into the port's dump), each
    package annotates its copy of SEGS; the ``prosody`` tiers are equal."""
    from speechflow_tpu.io import AudioSeg as JSeg
    from speechflow_tpu.scripts import prosody_annotation as jpa

    from speechflow_torch.io.seg import AudioSeg

    shutil.copy(dumps["jax"]["dump"] / "prosody_centroids.npy",
                dumps["port"]["dump"] / "prosody_centroids.npy")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SFTPU_DUMP_CACHE", raising=False)
        n_ref = jpa.main(["-cd", str(CFG), "-vs", "debug", "--dump_path",
                          str(dumps["jax"]["dump"]), "--data_root", str(dumps["jax"]["data"])])
    n = prosody_annotation.main(["-cd", str(CFG), "-vs", "debug", "--dump_path",
                                 str(dumps["port"]["dump"]),
                                 "--data_root", str(dumps["port"]["data"])])
    assert n == n_ref == 12
    changed = 0
    for f in sorted(dumps["port"]["data"].rglob("*.TextGridStage3")):
        g = dumps["jax"]["data"] / f.relative_to(dumps["port"]["data"])
        ours, ref = AudioSeg.load(f), JSeg.load(g)
        assert ours.grid["prosody"].intervals == ref.grid["prosody"].intervals
        changed += f.read_text() != (SEGS / f.relative_to(dumps["port"]["data"])).read_text()
    assert changed == 12


def test_data_pipeline_check_prints_jax_s_report(monkeypatch):
    from speechflow_tpu.scripts import data_pipeline_check as jcheck

    monkeypatch.delenv("SFTPU_DUMP_CACHE", raising=False)
    argv = ["-cd", str(CFG), "-vs", "debug", "--data_root", str(SEGS)]
    ref = jcheck.main(argv)
    assert data_pipeline_check.main(argv) == ref
    assert "[train] handler IO contracts: OK" in ref and len(ref) > 30
    profiled = data_pipeline_check.main(argv + ["--n_batches", "1", "--profile"])
    head = next(i for i, line in enumerate(profiled) if line.startswith("handler host ms"))
    assert [line.split()[0] for line in profiled[head + 1:]] == \
        configs("debug")[1]["preproc"]["pipe"]


def test_eval_tts_writes_jax_s_mel(tmp_path, monkeypatch):
    """(JAX's interface built without its feature cache, which gives every raw
    sentence the first one's features: ROADMAP §3.)"""
    from speechflow_tpu.scripts import eval_tts as jeval

    monkeypatch.delenv("SFTPU_DUMP_CACHE", raising=False)
    texts = ["Printing, in the only sense.", "It rained. Stop!"]
    jeval.main(["--tts_ckpt", str(_last_checkpoint("tts")), "--vocoder_ckpt",
                str(_last_checkpoint("vocoder")), "--out", str(tmp_path / "jax"),
                "--platform", "cpu", "--text", *texts])
    written = eval_tts.main(["--tts_ckpt", str(FIXTURE / "tts"), "--vocoder_ckpt",
                             str(FIXTURE / "vocoder"), "--out", str(tmp_path / "port"),
                             "--device", "cpu", "--text", *texts])
    assert [Path(w).name for w in written] == ["0.mel.npy", "0.wav", "1.mel.npy", "1.wav"]
    for i in range(2):
        ours = np.load(tmp_path / "port" / f"{i}.mel.npy")
        ref = np.load(tmp_path / "jax" / f"{i}.mel.npy")
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=2e-5 * np.abs(ref).max())


def _last_checkpoint(kind: str) -> Path:
    from speechflow_torch.training.saver import ExperimentSaver

    return ExperimentSaver.get_last_checkpoint(FIXTURE / kind)


def test_normalize_by_speaker_pipeline_matches_jax(tmp_path, monkeypatch):
    """``tests/test_signal1d.py``'s flow: ranges from a first pipeline's batch
    (normalised by the empty singleton: unchanged), then the pipeline that
    normalises by speaker from that ``ranges.json``; its collated batch, the
    per-utterance averages included, equals JAX's."""
    from speechflow_tpu.data.core.components import DataPipeline as JDP
    from speechflow_tpu.io import Config

    from tests.test_torch_handlers import _same

    monkeypatch.delenv("SFTPU_DUMP_CACHE", raising=False)
    cfg = _contour_cfg(SEGS)
    cfg["dataset"]["max_num_samples"] = 6
    jbatch0 = JDP(Config(copy.deepcopy(cfg))).init_components()["train"].sample_batch(4)
    dp0 = DataPipeline.from_config(cfg)
    ranges = dump.compute_ranges(dp0.process.sample(s)
                                 for s in dp0.samplers["train"].sampling(4)[0])
    from speechflow_tpu.scripts.dump import compute_ranges as jcompute

    assert ranges == jcompute(jbatch0.data_samples)
    (tmp_path / "ranges.json").write_text(json.dumps(ranges))
    cfg["singleton_handlers"] = {"SpeakerIDSetter": {}, "DatasetStatistics": {},
                                 "PhonemeStatistics": {},
                                 "StatisticsRange": {"ranges_file": str(tmp_path / "ranges.json")}}
    ref = JDP(Config(copy.deepcopy(cfg))).init_components()["train"].sample_batch(4)
    ours = DataPipeline.from_config(cfg).sample_batch("train", 4)
    c = ref.collated_samples
    assert c.averages is not None and set(c.averages) == {"pitch", "energy", "rate"}
    assert all(np.isfinite(v).all() for v in ours.averages.values())
    for name in ours.__dataclass_fields__:
        _same(getattr(ours, name), getattr(c, name), name)
    assert ours.pitch.max() <= 2.5 and ours.pitch.min() >= -1.0
