"""The data registries' new entries against the JAX package's: the parsers on
``BaseDSParser`` (``SimpleDSParser``, ``ImageDSParser``, ``EasyDSParser``,
``LibriSpeechDSParser``) and the base's machinery (preprocessing functions, a
spawned pool of 2, the skip of corrupt files, the pickle cache and its key),
``ImageCollate`` and ``NoCollate``, ``WeightedSampler`` and ``FillingSampler``
(their draws over 3 epochs), and a data config with no parser or collate type.
Host code on both sides: every field is held equal (arrays bit for bit)."""

import copy
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from speechflow_torch.data import collate as C
from speechflow_torch.data import parsers as P
from speechflow_torch.data import samplers as S
from speechflow_torch.data.core.components import DataPipeline
from speechflow_torch.data.core.datasample import AudioDataSample, ImageDataSample
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.io.seg import TextGrid, Tier

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
SEGS = REPO / "tests" / "data" / "SEGS"


def _same(a, b, what: str) -> None:
    """``a`` (the port's) equals ``b`` (JAX's): arrays bit for bit, audio chunks
    by file and window, timestamps by their intervals, samples field by field."""
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif type(b).__name__ == "Timestamps":
        np.testing.assert_array_equal(a.intervals, b.intervals, err_msg=what)
    elif type(b).__name__ == "AudioChunk":
        assert (Path(a.file_path), a.begin, a.end) == (Path(b.file_path), b.begin, b.end), what
    elif dataclasses.is_dataclass(b):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(b, dict):
        assert set(a) == set(b), what
        for k in b:
            _same(a[k], b[k], f"{what}[{k}]")
    else:
        assert a == b, (what, a, b)


def _same_samples(ours, ref) -> None:
    assert len(ours) == len(ref) > 0
    for i, (a, b) in enumerate(zip(ours, ref)):
        _same(a, b, f"sample {i}")


def test_registries_hold_every_jax_entry():
    """7 parsers, 6 collates (``TTSCollateWithPrompt`` is added to JAX's after its
    dict) and 5 samplers, JAX's names."""
    from speechflow_tpu.data.collate import COLLATES
    from speechflow_tpu.data.parsers import PARSERS
    from speechflow_tpu.data.samplers import SAMPLERS

    assert set(P.PARSERS) == set(PARSERS) and len(PARSERS) == 7
    assert set(C.COLLATES) == set(COLLATES) and len(COLLATES) == 6
    assert set(S.SAMPLERS) == set(SAMPLERS) and len(SAMPLERS) == 5


@pytest.fixture()
def librispeech(tmp_path):
    """``speaker/chapter/utterance`` grids with MFA ``words`` / ``phones`` tiers (the
    layout of ``tests/test_parsers_extra.py``): one with its wav beside it, one in
    an ``-align`` tree with the wav in the plain tree, one whose word has no
    phones, one without a ``phones`` tier."""
    sr = 16000
    wav = (0.1 * np.sin(2 * np.pi * 220 * np.arange(int(1.5 * sr)) / sr)).astype(np.float32)
    words = [(0.0, 0.2, ""), (0.2, 0.7, "hello"), (0.7, 0.8, ""), (0.8, 1.3, "world"),
             (1.3, 1.5, "")]
    phones = [(0.0, 0.2, "sil"), (0.2, 0.4, "HH"), (0.4, 0.55, "AH0"), (0.55, 0.7, "L"),
              (0.7, 0.8, "sp"), (0.8, 1.0, "W"), (1.0, 1.15, "ER1"), (1.15, 1.3, "spn"),
              (1.3, 1.5, "sil")]
    grids = []
    for root, name, tiers in (
            (tmp_path / "train", "1034-121119-0001", (words, phones)),
            (tmp_path / "train-align", "1034-121119-0002", (words, phones)),
            (tmp_path / "train", "1034-121119-0003", (words, phones[:4] + phones[8:])),
            (tmp_path / "train", "1034-121119-0004", (words, None))):
        d = root / "1034" / "121119"
        d.mkdir(parents=True, exist_ok=True)
        AudioChunk(data=wav, sr=sr).save(tmp_path / "train" / "1034" / "121119" / f"{name}.wav",
                                         overwrite=True)
        grid = TextGrid(0.0, 1.5)
        grid.add(Tier("words", tiers[0]))
        if tiers[1] is not None:
            grid.add(Tier("phones", tiers[1]))
        grid.save(d / f"{name}.TextGrid")
        grids.append(str(d / f"{name}.TextGrid"))
    return grids


def _npy_images(tmp_path):
    rng = np.random.default_rng(3)
    files = []
    for label in ("cat", "dog"):
        (tmp_path / label).mkdir()
        for i in range(3):
            path = tmp_path / label / f"{i}.npy"
            np.save(path, rng.normal(size=(8, 8, 1)).astype(np.float32))
            files.append(str(path))
    return files + [str(tmp_path / "README.txt")]


@pytest.mark.parametrize("name", ["SimpleDSParser", "ImageDSParser", "EasyDSParser",
                                  "LibriSpeechDSParser"])
def test_new_parsers_match_jax(name, tmp_path, librispeech):
    """The same files through each package's parser: the same samples, field by field
    (LibriSpeech: ``spn`` -> ``<UNK>``, silences dropped, the ``-align`` tree's wav
    found, the grid with a phone-less word and the one without phones give none)."""
    from speechflow_tpu.data import parsers as JP

    kwargs = {}
    if name == "LibriSpeechDSParser":
        files = librispeech
    elif name == "ImageDSParser":
        files = _npy_images(tmp_path)
        (tmp_path / "README.txt").write_text("not an image")
    else:
        files = [str(p) for p in sorted(SEGS.rglob("*.wav"))[:5]]
        if name == "EasyDSParser":
            kwargs["fn"] = os.path.getsize
    ours = P.PARSERS[name](**kwargs).read_datasamples(files)
    ref = list(getattr(JP, name)(**kwargs).read_datasamples(files))
    _same_samples(ours, ref)
    if name == "LibriSpeechDSParser":
        assert len(ours) == 2 and ours[0].phonemes[-1] == "<UNK>"
        assert Path(ours[1].audio_chunk.file_path).parent.parent.parent.name == "train"


def _keep_even(md):
    return md if int(Path(md["path"]).stem.split("_")[-1]) % 2 == 0 else None


def test_base_parser_machinery_matches_jax(tmp_path):
    """``BaseDSParser`` through ``EasyDSParser`` in both packages: a preprocessing
    function that drops records, a spawned pool of 2 over chunks of 2, a corrupt
    file skipped (or raised without ``skip_corrupted``), and the cache: the same
    ``parsed_<key>.pkl`` name, read back once the sources are gone."""
    from speechflow_tpu.data.parsers import EasyDSParser as JEasy

    files = []
    for i in range(7):
        path = tmp_path / "src" / f"utt_{i}.bin"
        path.parent.mkdir(exist_ok=True)
        path.write_bytes(b"x" * (10 + i))
        files.append(str(path))
    corrupt = files + [str(tmp_path / "src" / "utt_8.bin")]  # missing: getsize raises

    ours = P.EasyDSParser(fn=os.path.getsize, n_processes=2, chunk_size=2).read_datasamples(
        corrupt)
    # JAX's pool returns the chunks as they finish; the port's keeps the files' order
    ref = sorted(JEasy(fn=os.path.getsize, n_processes=2, chunk_size=2).read_datasamples(corrupt),
                 key=lambda s: s.file_path)
    assert [(s.index, s.file_path, s.additional["result"]) for s in ours] == \
        [(i, f, 10 + i) for i, f in enumerate(files)]
    assert [(s.file_path, s.additional) for s in ours] == [(s.file_path, s.additional)
                                                           for s in ref]
    for cls in (P.EasyDSParser, JEasy):
        with pytest.raises(FileNotFoundError):
            cls(fn=os.path.getsize, skip_corrupted=False).read_datasamples(corrupt)

    kept = dict(preproc_fns=[_keep_even])
    ours = P.EasyDSParser(fn=os.path.getsize, cache_dir=tmp_path / "c0", **kept)
    ref = JEasy(fn=os.path.getsize, cache_dir=tmp_path / "c1", **kept)
    a, b = ours.read_datasamples(files), list(ref.read_datasamples(files))
    _same_samples(a, b)
    assert [s.additional["result"] for s in a] == [10, 12, 14, 16]
    assert ours._cache_key(files) == ref._cache_key(files)
    assert [p.name for p in (tmp_path / "c0").iterdir()] == \
        [p.name for p in (tmp_path / "c1").iterdir()] == [f"parsed_{ours._cache_key(files)}.pkl"]
    for f in files:
        os.remove(f)
    _same_samples(ours.read_datasamples(files), b)


def test_image_and_no_collate_match_jax():
    """``ImageCollate`` stacks float32 images and gives new labels the next ids,
    as JAX's; ``NoCollate`` gives None."""
    from speechflow_tpu.data.collate import ImageCollate as JIC
    from speechflow_tpu.data.collate import NoCollate as JNC
    from speechflow_tpu.data.core.datasample import ImageDataSample as JIDS

    rng = np.random.default_rng(1)
    imgs = [rng.normal(size=(28, 28, 1)) for _ in range(5)]
    labels = ["3", "1", "3", "7", "0"]
    ours, ref = C.ImageCollate(label2id={"0": 0, "1": 1}), JIC(label2id={"0": 0, "1": 1})
    a = ours([ImageDataSample(image=i, label=lab) for i, lab in zip(imgs, labels)])
    b = ref([JIDS(image=i, label=lab) for i, lab in zip(imgs, labels)])
    _same(a, b, "batch")
    assert ours.label2id == ref.label2id == {"0": 0, "1": 1, "3": 2, "7": 3}
    assert C.NoCollate()([ImageDataSample()]) is None and JNC()([JIDS()]) is None


def _speaker_samples(pkg):
    from speechflow_tpu.data.core.datasample import AudioDataSample as JADS
    from speechflow_tpu.data.core.dataset import Dataset

    spk = ["a"] * 7 + ["b"] * 3 + ["c"] * 2
    lang = ["EN", "RU"] * 6
    cls = AudioDataSample if pkg == "port" else JADS
    samples = [cls(file_path=f"{i}.wav", speaker_name=s, lang=g, index=i)
               for i, (s, g) in enumerate(zip(spk, lang))]
    return samples if pkg == "port" else Dataset(samples)


@pytest.mark.parametrize("name,kwargs", [
    ("WeightedSampler", {}),
    ("WeightedSampler", dict(fields=["lang", "speaker_name"], alpha=0.5, epoch_size=9,
                             chunks_ratio=[0.3, 0.7], seed=4)),
    ("FillingSampler", {}),
    ("FillingSampler", dict(fields=["speaker_name", "lang"], seed=2)),
])
def test_drawing_samplers_match_jax(name, kwargs):
    """The same seed, the same batches and epoch ends as JAX's over 3 epochs, and
    the weighted sampler's probabilities exactly."""
    from speechflow_tpu.data import samplers as JS

    ours = getattr(S, name)(**copy.deepcopy(kwargs)).set_dataset(_speaker_samples("port"))
    ref = getattr(JS, name)(**copy.deepcopy(kwargs)).set_dataset(_speaker_samples("jax"))
    if name == "WeightedSampler":
        for f in ours.fields:
            np.testing.assert_array_equal(ours.probabilities(f), ref.probabilities(f))
    epochs = 0
    while epochs < 3:
        a, la = ours.sampling(5)
        b, lb = ref.sampling(5)
        assert [s.file_path for s in a] == [s.file_path for s in b] and la == lb
        epochs += la
    assert ours.epoch == ref.epoch == 4


def test_config_without_parser_or_collate_builds_as_in_jax():
    """``SimpleDSParser`` and the ``none`` collate by default: the same subsets and
    samples, and a batch collates to None in both."""
    from speechflow_tpu.data.core.components import DataPipeline as JDP
    from speechflow_tpu.data.core.singleton import Singleton
    from speechflow_tpu.io import Config

    cfg = {"dirs": {"data_root": str(SEGS)}, "file_search": {"ext": ".wav"},
           "dataset": {"subsets": ["train", "test"], "split_ratio": 0.8}}
    ours = DataPipeline.from_config(copy.deepcopy(cfg))
    try:
        ref = JDP(Config(copy.deepcopy(cfg))).init_components()
    finally:
        Singleton.clear()
    for subset in ("train", "test"):
        _same_samples(ours.datasets[subset], list(ref[subset].dataset))
    assert ours.datasets["train"][0].label == "000"
    assert ours.sample_batch("train", 4) is None
    assert ref["train"].collate_fn(list(ref["train"].dataset)[:4]) is None
