"""The acoustic model's data plane against the JAX package, over the repo's
corpus ``tests/data/SEGS`` (TextGridStage3 files with their wavs, EN and RU):
the TextGrid reader and parser, ``Timestamps.to_frames``, the spectral and
alignment handlers, the singletons, the training pipeline of
``configs/tts_data_24khz.yml`` (the ``debug`` values, through the port's
preset) down to the collated batches, the sampler's ``comb_by_len``, and
``model_config_from_info``. Host numpy on both sides: every field is held
equal (arrays bit for bit)."""

import dataclasses

import numpy as np
import pytest
import torch

from speechflow_torch.data.core.components import DataPipeline
from speechflow_torch.data.core.datasample import TTSDataSample
from speechflow_torch.data.parsers import TTSDSParser
from speechflow_torch.data.processors import get_handler
from speechflow_torch.data.processors.singletons import PhonemeStatistics, StatisticsRange
from speechflow_torch.data.samplers import RandomSampler, SimpleSampler
from speechflow_torch.io.flist import construct_file_list
from speechflow_torch.io.timestamps import Timestamps
from speechflow_torch.scripts.common import model_config_from_info
from speechflow_torch.scripts.train_tts import configs

torch.set_num_threads(1)
SEGS = "tests/data/SEGS"
TIERS = ("text", "phonemes", "lang", "speaker_name", "intonation_type", "pos_tags",
         "syntax_rels", "word_ids", "head_ids", "emphasis_labels", "prosody_labels",
         "syntagma_ids")


def _files():
    return construct_file_list(SEGS, ext=".TextGridStage3")


@pytest.fixture
def jax_pipeline(monkeypatch):
    """The JAX pipeline of the debug data config (its feature cache off)."""
    from speechflow_tpu.data.core.components import DataPipeline as JDP
    from speechflow_tpu.io import Config

    monkeypatch.delenv("SFTPU_DUMP_CACHE", raising=False)
    _, data_cfg = configs("debug", data_root=SEGS)
    return JDP(Config(data_cfg)).init_components()


def _equal(a, b, what: str) -> None:
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif hasattr(b, "intervals"):
        np.testing.assert_array_equal(a.intervals, b.intervals, err_msg=what)
    else:
        assert a == b, what


def test_parsed_samples_match_jax():
    """Every file through both parsers (the config's duration filters): the
    same samples, text, phonemes, timestamps, audio windows and word tiers."""
    from speechflow_tpu.data.parsers import TTSDSParser as J

    files = _files()
    kw = dict(max_duration=10.0, min_duration=0.5)
    ours, ref = TTSDSParser(**kw).read_datasamples(files), list(J(**kw).read_datasamples(files))
    assert len(ours) == len(ref) == len(files) == 50
    for a, b in zip(ours, ref):
        assert a.file_path == b.file_path and a.index == b.index
        for name in TIERS + ("phoneme_timestamps", "word_timestamps"):
            _equal(getattr(a, name), getattr(b, name), f"{a.file_path}: {name}")
        assert (a.audio_chunk.begin, a.audio_chunk.end) == (b.audio_chunk.begin,
                                                            b.audio_chunk.end)
    short = TTSDSParser(max_duration=3.0, languages=["EN"]).read_datasamples(files)
    assert 0 < len(short) < len(ours) and all(s.lang == "EN" for s in short)


@pytest.mark.parametrize("kw", [
    dict(audio_strip=True, audio_strip_pad=0.25),  # the aligner data configs' strip
    dict(audio_strip=True),
    dict(max_phoneme_length=0.25),
    dict(speakers=["Natasha"], min_duration=2.0),
], ids=["strip-pad", "strip", "max-phoneme", "speaker"])
def test_parser_options_match_jax(kw):
    """The parser's other options against JAX's: the audio window cut to the
    words (with a pad), the phonemes' timestamps shifted into it, and the
    phoneme-length and speaker filters."""
    from speechflow_tpu.data.parsers import TTSDSParser as J

    files = _files()
    ours, ref = TTSDSParser(**kw).read_datasamples(files), list(J(**kw).read_datasamples(files))
    assert 0 < len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.file_path == b.file_path and a.phonemes == b.phonemes
        _equal(a.phoneme_timestamps, b.phoneme_timestamps, a.file_path)
        _equal(a.word_timestamps, b.word_timestamps, a.file_path)
        assert (a.audio_chunk.begin, a.audio_chunk.end) == pytest.approx(
            (b.audio_chunk.begin, b.audio_chunk.end), abs=1e-9)


@pytest.mark.parametrize("n_frames", [None, "short", "long"])
def test_timestamps_to_frames_matches_jax(rng, n_frames):
    """Boundaries rounded to frames; with ``n_frames`` the residual goes to the
    last interval, a deficit pushed back through the earlier ones."""
    from speechflow_tpu.io import Timestamps as J

    edges = np.sort(rng.uniform(0.1, 4.0, 21))
    iv = np.stack([edges[:-1], edges[1:]], 1)
    total = int(np.round((edges[-1] - edges[0]) * 24000 / 256))
    target = {None: None, "short": total - 40, "long": total + 7}[n_frames]
    got = Timestamps(iv).to_frames(256, 24000, n_frames=target)
    np.testing.assert_array_equal(got, J(iv).to_frames(256, 24000, n_frames=target))
    if target is not None:
        assert got.sum() == target and (got >= 0).all()


def _load(ds):
    for name, kw in (("load_audio", {"sample_rate": 24000}), ("volume_normalize", {}),
                     ("multiple_audio", {"hop": 256})):
        ds = get_handler(name)(ds, **kw)
    return ds


@pytest.mark.parametrize("handler,kw", [
    ("magnitude", {"n_fft": 1024, "hop_len": 256}),
    ("linear_to_mel", {"n_mels": 80}),
    ("amp_to_db", {}),
    ("normalize_mel", {}),
    ("energy", {}),
    ("pitch", {"f0_min": 80.0, "f0_max": 880.0}),
])
def test_spectral_handlers_match_jax(handler, kw):
    """Each spectral handler, in the pipe's order, on a RU utterance (the
    handlers before it run on both sides): its field and parameters equal."""
    from speechflow_tpu.data.parsers import TTSDSParser as JP
    from speechflow_tpu.data.processors import get_handler as jget

    order = ["magnitude", "linear_to_mel", "amp_to_db", "normalize_mel", "energy", "pitch"]
    cfg = {"magnitude": {"n_fft": 1024, "hop_len": 256}, "linear_to_mel": {"n_mels": 80},
           "pitch": {"f0_min": 80.0, "f0_max": 880.0}}
    f = [p for p in _files() if "Natasha" in p][0]
    ours = _load(TTSDSParser().read_datasamples([f])[0])
    ref = JP().read_datasamples([f])[0]
    for name, jkw in (("load_audio", {"sample_rate": 24000}), ("volume_normalize", {}),
                      ("multiple_audio", {"hop": 256})):
        ref = jget(name)(ref, **jkw)
    for name in order[:order.index(handler)]:
        kw_ = cfg.get(name, {})
        ours, ref = get_handler(name)(ours, **kw_), jget(name)(ref, **kw_)
    ours, ref = get_handler(handler)(ours, **kw), jget(handler)(ref, **kw)
    field = {"magnitude": "magnitude", "energy": "energy", "pitch": "pitch"}.get(handler, "mel")
    _equal(getattr(ours, field), getattr(ref, field), handler)
    assert ours.transform_params == ref.transform_params
    if handler == "pitch":
        assert (ours.pitch > 0).any() and ours.pitch.shape == ours.magnitude.shape[:1]


def test_unported_pitch_methods_raise():
    """Every pitch method of JAX's handler is ported; as in JAX, ``crepe``
    without a ``crepe_ckpt`` and an unknown method raise ``ValueError``."""
    with pytest.raises(ValueError, match="crepe_ckpt"):
        get_handler("pitch")(TTSDataSample(), method="crepe")
    with pytest.raises(ValueError, match="unknown pitch method"):
        get_handler("pitch")(TTSDataSample(), method="dio")


def test_sample_len_and_the_comb_by_len_sampler():
    """``len(sample)`` is 1 as in JAX, so ``comb_by_len`` keeps the file order:
    the samplers' batches equal JAX's over two epochs."""
    from speechflow_tpu.data.parsers import TTSDSParser as JP
    from speechflow_tpu.data.samplers import RandomSampler as JR
    from speechflow_tpu.data.samplers import SimpleSampler as JS

    files = _files()
    ours, ref = TTSDSParser().read_datasamples(files), JP().read_datasamples(files)
    assert len(ours[0]) == len(TTSDataSample()) == 1
    for mine, theirs in ((SimpleSampler(comb_by_len=True), JS(comb_by_len=True)),
                         (RandomSampler(comb_by_len=True), JR(comb_by_len=True))):
        mine.set_dataset(ours)
        theirs.set_dataset(ref)
        for _ in range(2 * 50 // 16 + 1):
            a, la = mine.sampling(16)
            b, lb = theirs.sampling(16)
            assert [s.file_path for s in a] == [s.file_path for s in b] and la == lb
    simple = SimpleSampler(comb_by_len=True).set_dataset(ours)
    assert [s.file_path for s in simple.sampling(50)[0]] == files


def test_singletons_match_jax():
    """``PhonemeStatistics`` over the parsed corpus; ``StatisticsRange`` over
    samples that carry features, and empty at parse time, as in JAX."""
    from speechflow_tpu.data.core.singleton import Singleton
    from speechflow_tpu.data.parsers import TTSDSParser as JP
    from speechflow_tpu.data.processors.singletons import PhonemeStatistics as JPS
    from speechflow_tpu.data.processors.singletons import StatisticsRange as JSR

    Singleton.clear()  # JAX's singletons are one instance per process and thread
    try:
        ours, ref = TTSDSParser().read_datasamples(_files()), JP().read_datasamples(_files())
        a, b = PhonemeStatistics().fit(ours), JPS().fit(ref)
        assert a.state_dict() == b.state_dict() and a.symbols == b.symbols \
            and "<SIL>" in a.symbols
        assert StatisticsRange().fit(ours).state_dict() == {"ranges": {}}
        rng = np.random.default_rng(0)
        for s, r in zip(ours[:6], list(ref)[:6]):
            s.pitch = r.pitch = np.where(rng.random(50) > 0.3, rng.uniform(80, 300, 50),
                                         0).astype(np.float32)
            s.energy = r.energy = rng.uniform(0, 9, 50).astype(np.float32)
        got, want = StatisticsRange().fit(ours[:6]), JSR().fit(list(ref)[:6])
        assert got.state_dict() == want.state_dict() and got.ranges
    finally:
        Singleton.clear()


def test_collated_batches_equal_jax(jax_pipeline):
    """The debug data config over SEGS, parsed, fitted and split by both
    packages: the same info (alphabet from the phoneme statistics, singleton
    states, subset sizes); then a batch of each subset through every handler
    and ``TTSCollate``: every field of the port's batch equals JAX's."""
    _, data_cfg = configs("debug", data_root=SEGS)
    ours = DataPipeline.from_config(data_cfg)
    info, ref_info = ours.get_info(), jax_pipeline.get_info()
    for key in ("alphabet", "singletons", "dataset_sizes", "subsets"):
        assert info[key] == ref_info[key], key
    assert len(ours.alphabet) > 40 and ours.handler_names == data_cfg["preproc"]["pipe"]
    for subset, k in (("train", 3), ("test", 2)):
        mine = ours.datasets[subset][:k]
        theirs = list(jax_pipeline[subset].dataset)[:k]
        assert [s.file_path for s in mine] == [s.file_path for s in theirs]
        got = ours.datasample_to_batch([s.copy() for s in mine])
        want = jax_pipeline[subset].datasample_to_batch([s.copy() for s in theirs])
        want = want.collated_samples
        checked = 0
        for f in dataclasses.fields(got):
            value = getattr(got, f.name)
            if f.name == "additional":
                assert value == want.additional == {}
            elif value is None:
                assert getattr(want, f.name) is None, f.name
            else:
                _equal(value, getattr(want, f.name), f"{subset}.{f.name}")
                checked += 1
        assert checked == 19  # every field but the speaker embedding (none here)
        np.testing.assert_array_equal(got.gate[np.arange(k), got.mel_lengths - 1], 1.0)
        assert (got.durations.sum(1) == got.mel_lengths).all()


def test_model_config_from_info_matches_jax(jax_pipeline):
    from speechflow_tpu.io import Config
    from speechflow_tpu.scripts.common import model_config_from_info as J

    model_cfg, data_cfg = configs("debug", data_root=SEGS)
    ours = DataPipeline.from_config(data_cfg)
    got = model_config_from_info(model_cfg, ours)
    assert got == J(Config(model_cfg), jax_pipeline)
    assert got["n_symbols"] == len(ours.alphabet) and got["n_mels"] == 80


def test_loader_starts_its_workers_at_the_first_batch():
    """A loader never read (a validation subset before its first validation)
    starts no worker process, so it takes no host time from the training
    loader; its first ``next_batch`` starts them, ``close`` stops them."""
    import multiprocessing

    _, data_cfg = configs("debug", data_root=SEGS)
    pipeline = DataPipeline.from_config(data_cfg)
    before = set(multiprocessing.active_children())
    loader = pipeline.loader("test", 2, n_workers=1, prefetch_factor=1)
    try:
        assert set(multiprocessing.active_children()) == before
        batch = loader.next_batch()
        assert batch.mel.shape[0] == 2 and batch.gate is not None
        assert set(multiprocessing.active_children()) - before
    finally:
        loader.close()


def test_statistics_range_reads_a_ranges_file(tmp_path):
    """With a ``ranges.json`` (as a dump writes it), ``StatisticsRange`` takes
    its ranges and fitting keeps them, as JAX's does."""
    import json

    from speechflow_tpu.data.core.singleton import Singleton
    from speechflow_tpu.data.processors.singletons import StatisticsRange as JSR

    Singleton.clear(JSR)  # JAX's singletons are one instance per process and thread
    ranges = {"Natasha": {"pitch": [90.0, 310.0, 180.5, 40.25]}}
    path = tmp_path / "ranges.json"
    path.write_text(json.dumps(ranges))
    samples = TTSDSParser().read_datasamples(_files()[:3])
    for s in samples:
        s.pitch = np.full(20, 120.0, np.float32)
    try:
        got, want = StatisticsRange(str(path)).fit(samples), JSR(str(path)).fit(samples)
        assert got.state_dict() == want.state_dict() == {"ranges": ranges}
    finally:
        Singleton.clear(JSR)
