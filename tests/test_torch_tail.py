"""The io/utils/data-core tail of the port against the JAX package's, on the
CPU: dict helpers, ``Serialize``, ``Dataset`` / ``DatasetItem`` / ``Batch``, the
``Singleton`` metaclass, file lists, ``change_config_file``, the config-built
constructors, ``version_check`` and ``prune_checkpoint``, ``set_seed``,
``lengths_from_mask``, the IPA map, ``denormalize_mel_np`` / ``acf_f0_np`` and
the 1-D signal ops. Exact where both compute in the same precision, else within
``TOL`` of the largest magnitude (f32).
"""

import pickle
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechflow_torch.data.core.batch import Batch
from speechflow_torch.data.core.dataset import Dataset, DatasetItem
from speechflow_torch.data.core.singleton import Singleton
from speechflow_torch.data.processors import np_dsp
from speechflow_torch.data.processors.text import ARPABET_TO_IPA, phonemes_to_ipa, to_ipa
from speechflow_torch.io import flist
from speechflow_torch.io.config import change_config_file, yaml_load
from speechflow_torch.io.serialize import Serialize
from speechflow_torch.ops import signal
from speechflow_torch.utils import dictutils, misc
from speechflow_torch.utils.init import init_class_from_config, init_method_from_config
from speechflow_torch.utils.masks import lengths_from_mask
from speechflow_torch.utils.seed import set_seed

torch.set_num_threads(1)
TOL = 1e-5
SEGS = "tests/data/SEGS"
NESTED = {"a": {"b": 1, "c": {"d": [1, 2]}, "e": {}}, "f": "x", 3: {"g": None}}


class Item:
    """A sample with the metadata a dataset item reads."""

    def __init__(self, n: int, label: str, path: str):
        self.n, self.label, self.file_path = n, label, path

    def __len__(self) -> int:
        return self.n

    def __eq__(self, other) -> bool:
        return vars(self) == vars(other)


def test_dict_helpers_match_jax():
    from speechflow_tpu.utils import dictutils as J

    flat = dictutils.flatten_dict(NESTED)
    assert flat == J.flatten_dict(NESTED) and dictutils.flatten_dict(NESTED, "/") \
        == J.flatten_dict(NESTED, "/")
    assert dictutils.unflatten_dict(flat) == J.unflatten_dict(flat)
    base, upd = {"a": {"b": 1, "c": 2}, "d": 1}, {"a": {"c": 3, "x": {"y": 1}}, "d": {"z": 0}}
    assert dictutils.deep_update(dict(base), upd) == J.deep_update(dict(base), upd)


def test_serialize_matches_jax():
    from speechflow_tpu.io.serialize import Serialize as J

    obj = {"wave": np.arange(1000, dtype=np.float32), "meta": ["a", 1], "mel": np.ones((4, 3))}
    assert Serialize.dump(obj) == J.dump(obj) and Serialize.size(obj) == J.size(obj)
    assert pickle.loads(Serialize.dump(obj))["meta"] == obj["meta"]
    assert [Serialize.load(b)["meta"] for b in Serialize.dumps([obj, obj])] == [["a", 1]] * 2
    frames, jframes = Serialize.dump_frames(obj), J.dump_frames(obj)
    assert len(frames) == len(jframes) == 3
    assert [bytes(f) for f in frames] == [bytes(f) for f in jframes]
    back = Serialize.load_frames([bytes(f) for f in frames])
    np.testing.assert_array_equal(back["wave"], obj["wave"])
    assert not back["wave"].flags.writeable
    assert Serialize.load_frames(frames, writable=True)["mel"].flags.writeable
    assert J.load_frames(frames)["meta"] == Serialize.load_frames(jframes)["meta"]


@pytest.mark.parametrize("memory_save", [False, True])
def test_dataset_matches_jax(memory_save):
    from speechflow_tpu.data.core.dataset import Dataset as JDataset

    items = [Item(5, "b", "x/2.wav"), Item(2, "a", "x/1.wav"), Item(9, None, None)]
    ours, ref = Dataset(items, memory_save=memory_save), JDataset(items, memory_save=memory_save)
    assert len(ours) == len(ref) == 3 and list(ours) == list(ref) == items
    assert ours.get_file_list() == ref.get_file_list() and ours.labels() == ref.labels()
    assert [len(x) for x in ours.sort()] == [len(x) for x in ref.sort()] == [2, 5, 9]
    assert list(ours[1:]) == list(ref[1:]) and ours[0] == ref[0]
    assert list(ours.filter(lambda s: s.n > 2)) == list(ref.filter(lambda s: s.n > 2))
    it = ours.item(0)
    assert (it._obj is None) == memory_save and it.blob == Serialize.dump(items[1])
    assert isinstance(DatasetItem(blob=it.blob, memory_save=True).obj, Item)


def test_batch_and_singleton_match_jax():
    import dataclasses

    from speechflow_tpu.data.core.batch import Batch as JBatch
    from speechflow_tpu.data.core.singleton import Singleton as JSingleton

    assert [f.name for f in dataclasses.fields(Batch)] == \
        [f.name for f in dataclasses.fields(JBatch)]
    assert len(Batch(size=3)) == 3 and not Batch(size=3).is_last

    class Stats(metaclass=Singleton):
        def __init__(self):
            self.n = 0

    class Other(metaclass=Singleton):
        pass

    a, b = Stats(), Stats()
    assert a is b
    seen = []
    t = threading.Thread(target=lambda: seen.append(Stats()))
    t.start()
    t.join(10)
    assert not t.is_alive() and seen[0] is not a  # one instance a thread, as JAX's
    other = Other()
    Singleton.clear(Stats)
    assert Stats() is not a and Other() is other
    Singleton.clear()
    assert Other() is not other
    assert set(vars(JSingleton)) >= {"__call__", "clear"}
    Singleton.clear()


def test_file_lists_match_jax(tmp_path):
    from speechflow_tpu.io import flist as J

    assert flist.generate_file_list(SEGS, ext=".TextGridStage3", split_ratio=0.8, seed=3) == \
        J.generate_file_list(SEGS, ext=".TextGridStage3", split_ratio=0.8, seed=3)
    only_vctk = (lambda p: "VCTK" in str(p))
    assert flist.construct_file_list(SEGS, ".wav", path_filter=only_vctk) == \
        J.construct_file_list(SEGS, ".wav", path_filter=only_vctk)
    manifest = tmp_path / "train.txt"
    manifest.write_text("# comment\na/1.wav\n\n  b/2.wav \nc/3.wav\n", encoding="utf-8")
    for kw in ({}, {"data_root": "/data"}, {"max_num_samples": 2}):
        assert flist.read_file_list(manifest, **kw) == J.read_file_list(manifest, **kw)


def test_change_config_file_matches_jax(tmp_path):
    from speechflow_tpu.io.config import change_config_file as J

    text = open("configs/tts_model.yml", encoding="utf-8").read()
    ours, ref = tmp_path / "ours.yml", tmp_path / "ref.yml"
    ours.write_text(text, encoding="utf-8")
    ref.write_text(text, encoding="utf-8")
    updates = {"trainer.max_steps": 7, "optimizer.method": "adafactor", "new.section.key": [1, 2]}
    got = change_config_file(ours, updates, value_select=["debug"])
    want = J(ref, updates, value_select=["debug"])
    assert got.to_dict() == want.to_dict()
    assert yaml_load(ours.read_text()) == yaml_load(ref.read_text()) == want.to_dict()
    assert got["optimizer"]["method"] == "adafactor" and got["new"]["section"]["key"] == [1, 2]


def _scaled(x: float, y: str = "b", **kw):
    return x, y, kw


class Scaled:
    def __init__(self, x: float, y: str = "b"):
        self.args = (x, y)


def test_config_built_constructors_match_jax():
    from speechflow_tpu.utils.init import init_class_from_config as JC
    from speechflow_tpu.utils.init import init_method_from_config as JM

    cfg = {"x": 1.0, "y": "c", "unknown": 3}
    assert init_class_from_config(Scaled, cfg)().args == JC(Scaled, cfg)().args == (1.0, "c")
    assert init_class_from_config(Scaled, cfg)(y="d").args == JC(Scaled, cfg)(y="d").args
    with pytest.raises(TypeError):
        init_class_from_config(Scaled, cfg, check_params=False)()
    assert init_method_from_config(_scaled, cfg)() == JM(_scaled, cfg)()  # takes **kw
    assert init_method_from_config(_scaled, {"y": "q"})(2.0) == JM(_scaled, {"y": "q"})(2.0)


class _Mod:
    def __init__(self, version):
        self.__version__, self.__name__ = version, "mod"


@pytest.mark.parametrize("have,minimum,ok", [
    ("2.13.0", "2.13.0", True), ("2.13.0+cpu", "2.13.0", False), ("2.13.0+cpu", "2.13", True),
    ("1.9.9", "2.0", False), ("0.2.6", "0.2.5", True), ("3", "2.9.9", True),
])
def test_version_check_reads_as_jax_reads(have, minimum, ok):
    """JAX's check keeps the leading all-digit fields, so ``2.13.0+cpu`` reads
    as (2, 13), below 2.13.0; the port keeps that reading (ROADMAP §3)."""
    from speechflow_tpu.utils.misc import version_check as J

    assert misc.version_check(_Mod(have), minimum) == J(_Mod(have), minimum) == ok


def test_cuda_info_lists_no_device_here():
    assert misc.cuda_info() == []  # the CPU: no CUDA device visible
    assert 0 < misc.find_free_port() < 65536


def test_prune_checkpoint_of_a_jax_run(tmp_path):
    """A JAX checkpoint with its optax state (the committed resume run) pruned:
    the port's layout, the same weights and step, no optimizer state, no
    ``sources``, smaller on disk; a port checkpoint prunes the same way."""
    from speechflow_torch.convert import flatten_nnx
    from speechflow_torch.training.saver import ExperimentSaver

    src = "tests/data/jax_checkpoints/resume/tts/step_000000002"
    tree, payload = ExperimentSaver.load_checkpoint(src)
    assert tree["opt"] is not None
    out = misc.prune_checkpoint(src, tmp_path / "pruned")
    got, got_payload = ExperimentSaver.load_checkpoint(out)
    assert got["opt"] is None and got["step"] == int(tree["step"]) == 2
    assert "sources" not in got_payload and got_payload.keys() == \
        {k for k in payload if k != "sources"}
    want = flatten_nnx(tree["model"])
    have = flatten_nnx(got["model"])
    assert want.keys() == have.keys()
    assert all(np.array_equal(want[k], have[k]) for k in want)

    def size(p):
        return sum(f.stat().st_size for f in p.rglob("*") if f.is_file())

    from pathlib import Path
    assert size(out) < size(Path(src))
    again = misc.prune_checkpoint(out, tmp_path / "again", drop_optimizer=False)
    assert ExperimentSaver.load_checkpoint(again)[0]["opt"] is None


def test_set_seed_seeds_as_jax_does_and_torch():
    from speechflow_tpu.utils.seed import set_seed as J

    J(7)
    want = (random.random(), np.random.rand())
    set_seed(7)
    assert (random.random(), np.random.rand()) == want
    set_seed(7)
    a = torch.rand(3)
    set_seed(7)
    assert torch.equal(a, torch.rand(3))


def test_lengths_from_mask_matches_jax():
    from speechflow_tpu.utils.masks import lengths_from_mask as J

    mask = np.random.default_rng(0).uniform(size=(3, 4, 9)) > 0.4
    got = lengths_from_mask(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(J(jnp.asarray(mask))))


def test_ipa_map_matches_jax():
    from speechflow_tpu.data.processors import text as J

    assert ARPABET_TO_IPA == J.ARPABET_TO_IPA
    symbols = [p + s for p in ARPABET_TO_IPA for s in ("", "0", "1", "2")]
    symbols += ["<SIL>", "<BOS>", "xx", "", "aa1", "Q3"]
    assert phonemes_to_ipa(symbols) == J.phonemes_to_ipa(symbols)
    assert to_ipa("AA1") == "ˈɑ" and to_ipa("<SIL>") == "<SIL>"


def test_np_dsp_tail_matches_jax():
    from speechflow_tpu.data.processors import np_dsp as J
    from speechflow_torch.io.audio import AudioChunk

    mel = np.random.default_rng(0).uniform(-5.0, 4.0, size=(30, 80)).astype(np.float32)
    np.testing.assert_array_equal(np_dsp.denormalize_mel_np(mel), J.denormalize_mel_np(mel))
    wav = AudioChunk("tests/data/SEGS/EN/LJSpeech/000/2.wav").load(sr=24000).data
    t = np.arange(24000) / 24000.0
    tone = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    for x in (wav[:48000], tone):
        got, want = np_dsp.acf_f0_np(x, 24000), J.acf_f0_np(x, 24000)
        np.testing.assert_array_equal(got, want)
    assert np.median(np_dsp.acf_f0_np(tone, 24000)[4:-4]) == pytest.approx(220.0, rel=0.01)


def _jx(a):
    return jnp.asarray(a)


SIGNAL_CASES = [
    ("preemphasis", {"coeff": 0.9}),
    ("deemphasis", {"coeff": 0.97}),
    ("energy", {}),
    ("spectral_flatness", {}),
    ("mu_law_encode", {"mu": 255}),
    ("mu_law_decode", {"mu": 127}),
    ("rms_normalize", {"target_dbfs": -20.0}),
    ("smooth_1d", {"win": 5}),
    ("clip_quantile", {"q_low": 0.05, "q_high": 0.9}),
]


@pytest.mark.parametrize("name,kw", SIGNAL_CASES, ids=[c[0] for c in SIGNAL_CASES])
def test_signal_ops_match_jax(name, kw):
    from speechflow_tpu.ops import signal as J

    x = np.random.default_rng(len(name)).normal(size=(3, 257)).astype(np.float32)
    if name in ("energy", "spectral_flatness"):
        x = np.abs(x).reshape(3, 257, 1) * np.ones((1, 1, 16), np.float32)
        x[..., 3] += 1.0
    if name == "mu_law_decode":
        x = np.tanh(x)
    got = getattr(signal, name)(torch.from_numpy(x), **kw).numpy()
    want = np.asarray(getattr(J, name)(_jx(x), **kw))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL * max(float(np.abs(want).max()), 1.0), name


def test_range_normalize_and_dither_match_jax():
    from speechflow_tpu.ops import signal as J

    x = np.random.default_rng(0).normal(size=(2, 50)).astype(np.float32)
    lo, hi = np.float32(-1.5), np.array([[2.0], [2.0]], np.float32)
    np.testing.assert_allclose(signal.range_normalize(torch.from_numpy(x), lo,
                                                      torch.from_numpy(hi)).numpy(),
                               np.asarray(J.range_normalize(_jx(x), lo, _jx(hi))), rtol=1e-6)
    np.testing.assert_allclose(signal.range_normalize(torch.from_numpy(x), 1.0, 1.0).numpy(),
                               np.asarray(J.range_normalize(_jx(x), 1.0, 1.0)), rtol=1e-6)
    # JAX draws its noise from a key, the port from a generator: the same law
    gen = torch.Generator().manual_seed(0)
    big = torch.zeros(200_000)
    noise = (signal.dither(big, gen, amount=1e-3) - big) / 1e-3
    jnoise = np.asarray(J.dither(jnp.zeros(200_000), jax.random.PRNGKey(0), amount=1e-3)) / 1e-3
    for a in (noise.numpy(), jnoise):
        assert abs(a.mean()) < 0.01 and abs(a.std() - 1.0) < 0.01
    assert torch.equal(signal.dither(big, torch.Generator().manual_seed(1)),
                       signal.dither(big, torch.Generator().manual_seed(1)))


def test_convert_media_to_opus_matches_jax(tmp_path):
    """Two SEGS wavs re-encoded as Ogg/Opus beside themselves by each package: the
    same files written, each the same audio to the Opus codec's rounding."""
    import shutil

    from speechflow_tpu.annotator.asr import convert_media_to_opus as J

    from speechflow_torch.annotator.asr import convert_media_to_opus
    from speechflow_torch.io.audio import AudioChunk

    wavs = ["tests/data/SEGS/EN/LJSpeech/000/2.wav", "tests/data/SEGS/EN/LJSpeech/000/5.wav"]
    for side in ("ours", "ref"):
        (tmp_path / side).mkdir()
        for w in wavs:
            shutil.copy(w, tmp_path / side / w.rsplit("/", 1)[1])
    got = convert_media_to_opus(tmp_path / "ours", sr=24000)
    want = J(tmp_path / "ref", sr=24000)
    assert [p.name for p in got] == [p.name for p in want] == ["2.opus", "5.opus"]
    for a, b in zip(got, want):
        x, y = AudioChunk(a).load(sr=24000).data, AudioChunk(b).load(sr=24000).data
        assert abs(len(x) - len(y)) <= 1024
        n = min(len(x), len(y))
        assert float(np.abs(x[:n] - y[:n]).max()) < 0.1 * float(np.abs(y).max())
    mtime = got[0].stat().st_mtime_ns
    assert convert_media_to_opus(tmp_path / "ours") == got  # kept unless overwrite
    assert got[0].stat().st_mtime_ns == mtime
