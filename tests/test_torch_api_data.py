"""The data-layer names and keywords this slice adds, against the JAX package
over ``tests/data/SEGS``: the ``DataSample`` hierarchy and its methods (the
port's own pickles round-tripped, every field compared with JAX's sample of
the same metadata), the parsers' ``reader`` / ``run_preprocessing`` /
``to_datasample(md)`` and ``read_datasamples(memory_save=, progress=)``,
``DataPipeline(cfg).init_components()`` and ``pipeline[subset]``
(``PipelineComponents``) giving JAX's batches and ``from_config``'s,
``init_from_config``, ``with_ignored_fields`` / ``with_ignored_handlers``,
``BaseSingleton``, ``SpeakerIDSetter(resume_from=)`` and its counts,
``StatisticsRange.as_arrays``, the ``Alphabet`` ids, ``BaseSampler``,
``DumpProcessor(fields=, persist_blacklist=)``, the data loaders from a
config path, and the small keywords of the utilities (``masked_mean(axis=)``,
``naive_cqt_np``, ``broadcast_bytes(max_len=)``, ``run_audio_transcription(
n_processes=)``, ``ExperimentSaver(dump_sources=, source_root=)``,
``LoggingServer(address=)``, ``VocoderEvaluationInterface(ckpt_path=)``).
Exact equality (arrays bit for bit) unless a line says otherwise. JAX's
singletons are one instance per process and thread: cleared before and after."""

import dataclasses
import logging
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from speechflow_torch.data.core import datasample as DS
from speechflow_torch.data.core.components import DataPipeline, PipelineComponents
from speechflow_torch.data.core.dataset import Dataset
from speechflow_torch.data.parsers import AudioDSParser, ProsodyParser, TTSDSParser
from speechflow_torch.io.config import Config
from speechflow_torch.io.flist import construct_file_list

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
SEGS = REPO / "tests" / "data" / "SEGS"
GRIDS = construct_file_list(SEGS, ext=".TextGridStage3")
WAIT = 60


@pytest.fixture(autouse=True)
def _clear_jax_singletons(monkeypatch):
    from speechflow_tpu.data.core.singleton import Singleton

    monkeypatch.delenv("SFTPU_DUMP_CACHE", raising=False)
    Singleton.clear()
    yield
    Singleton.clear()


def _equal(a, b, what: str) -> None:
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif hasattr(b, "intervals"):
        np.testing.assert_array_equal(a.intervals, b.intervals, err_msg=what)
    elif hasattr(b, "file_path") and hasattr(b, "begin"):
        assert (a.file_path, a.begin, a.end, a.sr) == (b.file_path, b.begin, b.end, b.sr), what
    else:
        assert a == b, what


def _same_sample(ours, ref) -> None:
    assert ours.field_names() == ref.field_names()
    for name in ref.field_names():
        _equal(getattr(ours, name), getattr(ref, name), name)


def test_datasample_hierarchy_and_methods():
    for cls in (DS.AudioDataSample, DS.ImageDataSample, DS.ProsodyPredictionDataSample,
                DS.SpectrogramDataSample, DS.TTSDataSample):
        assert issubclass(cls, DS.DataSample)
    ds = DS.TTSDataSample(file_path="a", text="hi",
                          transform_params={"pitch": {"method": "yin", "hop": 256}},
                          additional={"extra": 3})
    assert ds.get("text") == "hi" and ds.get("extra") == 3 and ds.get("none", 7) == 7
    assert ds.setdefaults(text="no", lang="EN") is ds and (ds.text, ds.lang) == ("hi", "EN")
    assert ds.get_param_val("hop") == 256 and ds.get_param_val("x", -1) == -1
    assert DS.AudioDataSample().waveform is None


@pytest.mark.parametrize("grid", GRIDS[::4], ids=lambda p: Path(p).stem + Path(p).parent.name)
def test_parsed_samples_round_trip_and_match_jax(grid):
    from speechflow_tpu.data.parsers import TTSDSParser as JP

    ours_p, ref_p = TTSDSParser(), JP()
    md, ref_md = ours_p.reader(grid)[0], ref_p.reader(grid)[0]
    assert md["path"] == ref_md["path"]
    ours = ours_p.to_datasample(ours_p.run_preprocessing(md))
    ref = ref_p.to_datasample(ref_p.run_preprocessing(ref_md))
    back = DS.DataSample.deserialize(ours.serialize())
    assert type(back) is DS.TTSDataSample and back.uid == ref.uid
    _same_sample(back, ref)
    assert ours.get("phonemes") == ref.get("phonemes")
    assert ours.get_param_val("x", 1) == ref.get_param_val("x", 1)


def test_parser_filters_match_jax():
    from speechflow_tpu.data.parsers import TTSDSParser as JP

    kw = dict(max_duration=4.0, min_duration=1.0, max_phoneme_length=0.2)
    ours, ref = TTSDSParser(**kw), JP(**kw)
    kept = [ours.run_preprocessing(ours.reader(f)[0]) is not None for f in GRIDS]
    want = [ref.run_preprocessing(ref.reader(f)[0]) is not None for f in GRIDS]
    assert kept == want and 0 < sum(kept) < len(GRIDS)


def test_read_datasamples_memory_save_and_progress(caplog):
    from speechflow_tpu.data.parsers import TTSDSParser as JP

    files = GRIDS[:6]
    plain = TTSDSParser(chunk_size=2).read_datasamples(files)
    with caplog.at_level(logging.INFO, logger="speechflow_torch"):
        saved = TTSDSParser(chunk_size=2).read_datasamples(files, memory_save=True,
                                                           progress=True)
    ref = JP(chunk_size=2).read_datasamples(files, memory_save=True)
    assert isinstance(saved, Dataset) and len(saved) == len(plain) == len(ref) == 6
    assert [r.getMessage() for r in caplog.records if "chunks" in r.getMessage()] == \
        [f"parsed {k}/3 chunks" for k in (1, 2, 3)]
    for a, b, c in zip(saved, plain, ref):
        _same_sample(a, c)
        _same_sample(b, c)


def test_audio_and_prosody_parsers_match_jax():
    from speechflow_tpu.data.parsers import AudioDSParser as JA
    from speechflow_tpu.data.parsers import ProsodyParser as JPr

    wavs = construct_file_list(SEGS, ext=".wav")[:5]
    for ours, ref in zip(AudioDSParser().read_datasamples(wavs), JA().read_datasamples(wavs)):
        _same_sample(ours, ref)
    p, jp = ProsodyParser(vocab_size=50), JPr(vocab_size=50)
    for f in GRIDS[:5]:
        a, b = p.to_datasample(p.reader(f)[0]), jp.to_datasample(jp.reader(f)[0])
        assert isinstance(a, DS.DataSample) and a.words == b.words
        np.testing.assert_array_equal(a.token_ids, b.token_ids)


def _data_cfg(tmp_path: Path) -> Path:
    """``configs/tts_data_24khz.yml`` with its data root at this checkout's SEGS."""
    cfg = Config.create_from_file(REPO / "configs" / "tts_data_24khz.yml")
    cfg.set_path("dirs.data_root", str(SEGS))
    path = tmp_path / "data.yml"
    cfg.to_file(path)
    return path


def _batch_equal(got, want, what: str) -> int:
    checked = 0
    for f in dataclasses.fields(got):
        value = getattr(got, f.name)
        if value is None or f.name == "additional":
            assert getattr(want, f.name) in (None, {}), f.name
            continue
        _equal(value, getattr(want, f.name), f"{what}.{f.name}")
        checked += 1
    return checked


def test_pipeline_components_give_jax_batches(tmp_path):
    from speechflow_tpu.data.core.components import DataPipeline as JDP

    path = _data_cfg(tmp_path)
    ours = DataPipeline.init_from_config(path, value_select=["debug"]).init_components()
    ref = JDP.init_from_config(path, value_select=["debug"]).init_components()
    assert ours.subsets == ref.subsets and isinstance(ours["train"], PipelineComponents)
    for key in ("alphabet", "singletons", "dataset_sizes", "subsets", "config"):
        assert ours.get_info()[key] == ref.get_info()[key], key
    comp, ref_comp = ours["train"], ref["train"]
    assert [s.file_path for s in comp.dataset] == [s.file_path for s in ref_comp.dataset]
    assert sorted(comp.singletons) == sorted(ref_comp.singletons)
    got, want = comp.sample_batch(3), ref_comp.sample_batch(3)
    assert (got.size, got.is_last) == (want.size, want.is_last)
    assert _batch_equal(got.collated_samples, want.collated_samples, "train") > 15
    # the old entry gives the same batches
    old = DataPipeline.from_config(Config.create_from_file(path, value_select=["debug"]))
    _batch_equal(old.sample_batch("train", 3), got.collated_samples, "from_config")
    samples = [s.copy() for s in list(ours["test"].dataset)[:2]]
    ref_samples = [s.copy() for s in list(ref["test"].dataset)[:2]]
    _batch_equal(ours["test"].datasample_to_batch(samples).collated_samples,
                 ref["test"].datasample_to_batch(ref_samples).collated_samples, "test")


def test_ignored_fields_and_handlers_match_jax(tmp_path):
    from speechflow_tpu.data.core.components import DataPipeline as JDP
    from speechflow_tpu.data.core.registry import PipeRegistry
    from speechflow_tpu.data.parsers import TTSDSParser as JP

    path = _data_cfg(tmp_path)
    ref = JDP.init_from_config(path, value_select=["debug"])
    ours = DataPipeline.init_from_config(path, value_select=["debug"])
    datasets = {s: TTSDSParser().read_datasamples(GRIDS[:4]) for s in ours.subsets}
    ref_sets = {s: JP().read_datasamples(GRIDS[:4]) for s in ref.subsets}
    for fields, handlers in (({"pitch"}, set()), (set(), {"magnitude", "ssl_features"}),
                             ({"mel"}, {"add_lm_feat"})):
        mine = ours.with_ignored_fields(fields).with_ignored_handlers(handlers)
        theirs = ref.with_ignored_fields(fields).with_ignored_handlers(handlers)
        assert (mine.ignored_fields, mine.ignored_handlers) == \
            (theirs.ignored_fields, theirs.ignored_handlers)
        mine.init_components(datasets={s: list(d) for s, d in datasets.items()})
        theirs.init_components(datasets=ref_sets)
        want = [PipeRegistry.meta(fn)["name"] for fn in theirs["train"].preproc_fns]
        assert mine.handler_names == want and len(want) < len(ours.cfg.preproc.pipe)
        info = theirs.get_info()
        again = DataPipeline.from_info(info, ignored_fields=fields, ignored_handlers=handlers)
        assert again.handler_names == want
        with pytest.raises(TypeError, match="from_info"):  # an info payload is not a config
            DataPipeline(info)


def test_singletons_alphabet_and_samplers_match_jax():
    from speechflow_torch.data.processors import singletons as S
    from speechflow_torch.data.processors.text import Alphabet
    from speechflow_torch.data.samplers import SAMPLERS, BaseSampler
    from speechflow_tpu.data.processors import singletons as J
    from speechflow_tpu.data.processors.text import Alphabet as JAlphabet

    for cls in S.SINGLETON_HANDLERS.values():
        assert issubclass(cls, S.BaseSingleton)
    for cls in SAMPLERS.values():
        assert issubclass(cls, BaseSampler)
    with pytest.raises(NotImplementedError):
        BaseSampler().set_dataset([1, 2]).sampling(1)
    assert len(BaseSampler().set_dataset([1, 2, 3])) == 3
    samples = TTSDSParser().read_datasamples(GRIDS)
    state = {"speaker2id": {"zz": 0}, "lang2id": {"XX": 0}}
    ours = S.SpeakerIDSetter(resume_from=state).fit(samples)
    ref = J.SpeakerIDSetter(resume_from=state).fit(samples)
    assert ours.state_dict() == ref.state_dict()
    assert (ours.n_speakers, ours.n_langs) == (ref.n_speakers, ref.n_langs) == (
        len(ref.speaker2id), len(ref.lang2id))
    ranges = {"speaker_a": {"pitch": (80.0, 300.0, 150.0, 30.0)},
              "__all__": {"pitch": (70.0, 320.0, 160.0, 35.0), "energy": (0.0, 1.0, 0.5, 0.1)}}
    sr, jsr = S.StatisticsRange(), J.StatisticsRange()
    sr.load_state_dict({"ranges": ranges})
    jsr.load_state_dict({"ranges": ranges})
    for feat in ("pitch", "energy", "aggregate_pitch"):
        for spk2id in ({"speaker_a": 0, "speaker_b": 1}, {}):
            got, want = sr.as_arrays(feat, spk2id), jsr.as_arrays(feat, spk2id)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    symbols = ["a", "b", "c"]
    a, ja = Alphabet(symbols), JAlphabet(symbols)
    assert (a.pad_id, a.sil_id, a.bos_id, a.eos_id) == (ja.pad_id, ja.sil_id, ja.bos_id,
                                                        ja.eos_id)
    base = S.BaseSingleton()
    assert base.apply(7) == 7 and base.aggregate(None) is base


@pytest.mark.parametrize("persist", [True, False])
def test_dump_processor_keywords_match_jax(tmp_path, persist, caplog):
    from speechflow_torch.data.core.processor import DumpProcessor
    from speechflow_tpu.data.core.processor import DumpProcessor as JDump

    ds = DS.DataSample(file_path="x.wav")
    with caplog.at_level(logging.WARNING, logger="speechflow_torch"):
        ours = DumpProcessor(tmp_path / "ours", fields=["mel"], persist_blacklist=persist)
    assert "select nothing" in caplog.text  # fields: a knob with no effect, as in JAX
    ref = JDump(tmp_path / "ref", fields=["mel"], persist_blacklist=persist)
    for d in (ours, ref):
        d.blacklist(ds)
    assert ours.fields == ref.fields and ours.skip_samples == ref.skip_samples
    assert (tmp_path / "ours" / "skip_samples.txt").exists() == \
        (tmp_path / "ref" / "skip_samples.txt").exists() == persist
    again = DumpProcessor(tmp_path / "ours", persist_blacklist=persist)
    assert again.skip_samples == JDump(tmp_path / "ref", persist_blacklist=persist).skip_samples


def test_data_loader_from_a_config_path(tmp_path):
    from speechflow_torch.server import get_dataset_iterator, init_data_loader

    cfg = Config.create_from_file(REPO / "configs" / "vocoder_data_24khz.yml")
    cfg.set_path("dirs.data_root", str(SEGS))
    path = tmp_path / "voc.yml"
    cfg.to_file(path)
    bundle = init_data_loader(config_path=path, value_select=["debug"], subsets=["train"],
                              batch_size=2, n_workers=1, prefetch_factor=2)
    try:
        got = bundle["train"].next_item(timeout=WAIT)
    finally:
        bundle.shutdown()
    pipeline = DataPipeline.init_from_config(path, value_select=["debug"]).init_components()
    want = next(get_dataset_iterator(pipeline, "train", 2))
    assert got.keys == want.keys and got.collated.waveform.shape[0] == 2


def test_masked_mean_axis_matches_jax():
    import jax.numpy as jnp

    from speechflow_torch.utils.masks import masked_mean
    from speechflow_tpu.utils.masks import masked_mean as J

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3)).astype(np.float32)
    mask = np.arange(5)[None] < np.array([5, 3])[:, None]
    for axis in (None, 1, (1, 2)):
        got = masked_mean(torch.from_numpy(x), torch.from_numpy(mask), axis=axis)
        want = J(jnp.asarray(x), jnp.asarray(mask), axis=axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(masked_mean(torch.from_numpy(x), torch.from_numpy(mask), 1),
                               masked_mean(torch.from_numpy(x), torch.from_numpy(mask),
                                           axis=1), rtol=0, atol=0)  # JAX's position


def test_naive_cqt_matches_jax():
    from speechflow_torch.ops.cqt import naive_cqt_np
    from speechflow_tpu.ops.cqt import naive_cqt_np as J

    wav = np.random.default_rng(1).normal(size=700)
    for kw in (dict(upsample=True), dict(upsample=False, bins_per_octave=6)):
        np.testing.assert_array_equal(naive_cqt_np(wav, 8000, 128, 500.0, 2, **kw),
                                      J(wav, 8000, 128, 500.0, 2, **kw))


def test_broadcast_bytes_max_len(monkeypatch):
    from speechflow_torch.parallel import distributed as D

    assert D.broadcast_bytes(b"x" * 5000, max_len=10) == b"x" * 5000  # one process: as is

    class _Dist:
        @staticmethod
        def broadcast_object_list(box, src=0):
            return None

    monkeypatch.setattr(D, "is_distributed", lambda: True)
    monkeypatch.setattr(D, "process_index", lambda: 0)
    monkeypatch.setattr(D, "_dist", lambda: _Dist)
    assert D.broadcast_bytes(b"y" * 10, max_len=10) == b"y" * 10
    # no fixed buffer: a longer payload goes through (a rank raising alone would
    # leave the others blocked in the collective)
    assert D.broadcast_bytes(b"y" * 11, max_len=10) == b"y" * 11
    assert D.broadcast_bytes(b"y" * 1025) == b"y" * 1025


def test_run_audio_transcription_takes_n_processes(tmp_path):
    from speechflow_torch.annotator.asr import ASRBase, run_audio_transcription

    for k in range(3):
        (tmp_path / f"{k}.wav").write_bytes(b"")

    class Fake(ASRBase):
        def transcribe(self, wav, sr):
            return {"text": "x"}

        def __call__(self, path):
            return {"text": Path(path).stem}

    assert run_audio_transcription(tmp_path, asr=Fake(), n_processes=4) == 3
    ours = {p.name: p.read_text() for p in tmp_path.glob("*.whisper")}
    from speechflow_tpu.annotator.asr import run_audio_transcription as J

    assert J(tmp_path, asr=Fake(), n_processes=4, overwrite=True) == 3
    assert {p.name: p.read_text() for p in tmp_path.glob("*.whisper")} == ours
    assert len(ours) == 3


def test_saver_dump_sources(tmp_path):
    from speechflow_torch.training.saver import ExperimentSaver

    src = tmp_path / "src"
    (src / "pkg").mkdir(parents=True)
    (src / "pkg" / "a.py").write_text("x = 1\n")
    (src / "cfg.yml").write_text("a: 1\n")
    (src / ".hidden").mkdir()
    (src / ".hidden" / "b.py").write_text("no\n")
    (src / "data.bin").write_bytes(b"\0")
    saver = ExperimentSaver(tmp_path / "exp", dump_sources=True, source_root=src)
    assert saver.to_save["sources"] == {"pkg/a.py": "x = 1\n", "cfg.yml": "a: 1\n"}
    from speechflow_tpu.training.saver import ExperimentSaver as JSaver

    assert saver.to_save["sources"] == JSaver._dump_sources(src)
    assert "sources" not in ExperimentSaver(tmp_path / "exp2").to_save


def test_logging_server_address():
    from speechflow_torch.logging.server import LoggingServer
    from speechflow_torch.server.transport import find_free_port

    port = find_free_port()
    for address in (f"127.0.0.1:{port}", f"tcp://127.0.0.1:{find_free_port()}"):
        server = LoggingServer(Path("/dev/null"), address=address)
        try:
            assert server.address == address.split("://")[-1]
        finally:
            server._server.server_close()


def test_vocoder_interface_from_ckpt_path():
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.training.saver import ExperimentSaver

    ckpt = ExperimentSaver.get_last_checkpoint(REPO / "tests" / "data" / "jax_checkpoints"
                                               / "vocoder")
    by_path = VocoderEvaluationInterface(ckpt_path=ckpt, device="cpu")
    by_tree = VocoderEvaluationInterface.from_checkpoint(*ExperimentSaver.load_checkpoint(ckpt),
                                                         device="cpu")
    mel = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 8, by_tree.params.n_mels)).astype(np.float32))
    np.testing.assert_array_equal(by_path.synthesize(mel).waveform,
                                  by_tree.synthesize(mel).waveform)
    assert pickle.loads(pickle.dumps(by_path.payload["model_params"])) == \
        by_tree.payload["model_params"]
    with pytest.raises(ValueError):
        VocoderEvaluationInterface()
