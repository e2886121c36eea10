"""The IO names and keywords this slice adds, against the JAX package:
``Config`` (attribute access, nested sections, ``section``/``trim``/``drop``/
``find``/``get_path``/``setdefault``/``copy`` and the ``hash`` of every recipe
under each selector), ``Timestamps`` (``duration``, ``durations``, ``copy``,
``shift``, ``scale``, ``append``), ``Tier`` (``timestamps``, ``shift``,
``window``), ``AudioSeg`` (``tier``, ``phoneme_labels``,
``phoneme_timestamps``, ``split_into_syntagmas`` on every SEGS utterance,
``load(audio_path=, load_audio=)``), ``AudioChunk`` (``empty``, ``copy``,
``from_bytes``, ``mu_law_decode``, ``load(dtype=)``) and the codec flags.
Exact equality throughout: strings, intervals, arrays, digests."""

from pathlib import Path

import numpy as np
import pytest
import torch

from speechflow_torch.io import codecs
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.io.config import Config
from speechflow_torch.io.seg import AudioSeg, Tier
from speechflow_torch.io.timestamps import Timestamps

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
SEGS = REPO / "tests" / "data" / "SEGS"
GRIDS = sorted(SEGS.rglob("*.TextGridStage3"))


def _j():
    import speechflow_tpu.io.audio as JA
    import speechflow_tpu.io.config as JC
    import speechflow_tpu.io.seg as JS
    import speechflow_tpu.io.timestamps as JT

    return JA, JC, JS, JT


@pytest.mark.parametrize("select", [None, "debug", "ru"])
@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("*.yml")), ids=lambda p: p.name)
def test_config_hash_and_sections_match_jax(path, select):
    jc = _j()[1]
    vs = None if select is None else [select]
    ours = Config.create_from_file(path, value_select=vs)
    ref = jc.Config.create_from_file(path, value_select=vs)
    assert ours.hash == ref.hash and ours.to_dict() == ref.to_dict()
    for name in list(ref)[:4]:
        assert ours.section(name).to_dict() == ref.section(name).to_dict()
        assert type(getattr(ours, name)) is (Config if isinstance(ref[name], dict)
                                             else type(ref[name]))
    keep = list(ref)[:2]
    assert ours.trim(keep).hash == ref.trim(keep).hash
    assert ours.drop(keep).hash == ref.drop(keep).hash
    for key in ("dim", "data_root", "pipe", "type", "batch_size", "absent"):
        assert ours.find(key) == ref.find(key)
    for dotted in ("model.dim", "preproc.pipe", "dirs.data_root", "model.absent.x"):
        assert ours.get_path(dotted, "-") == ref.get_path(dotted, "-")


def test_config_mutation_matches_jax():
    jc = _j()[1]
    data = {"a": {"b": 1, "c": [1, 2, {"d": 3}]}, "e": "x"}
    ours, ref = Config(data, f=2.5), jc.Config(data, f=2.5)
    for cfg in (ours, ref):
        cfg["g"] = {"h": {"i": 1}}
        cfg.setdefault("j", {"k": 2})
        cfg.setdefault("e", "unused")
        cfg.set_path("a.z.y", 7)
    assert ours.to_dict() == ref.to_dict() and ours.hash == ref.hash
    assert isinstance(ours.g.h, Config) and isinstance(ours.j, Config) and ours.g.h.i == 1
    assert ours.section("e").to_dict() == ref.section("e").to_dict() == {"e": "x"}
    assert ours.section("none", {"q": 1}).to_dict() == ref.section("none", {"q": 1}).to_dict()
    copied = ours.copy()
    copied.a["b"] = 5
    assert ours.a.b == 1 and copied.hash != ours.hash
    with pytest.raises(AttributeError):
        ours.absent


def test_timestamps_match_jax():
    jt = _j()[3]
    iv = np.array([[0.1, 0.4], [0.4, 0.9], [0.9, 1.25]])
    ours, ref = Timestamps(iv), jt.Timestamps(iv)
    assert ours.duration == ref.duration
    np.testing.assert_array_equal(ours.durations, ref.durations)
    for a, b in ((ours.shift(0.5), ref.shift(0.5)), (ours.scale(2.0), ref.scale(2.0)),
                 (ours.append(ours[:2]), ref.append(ref[:2])), (ours.copy(), ref.copy())):
        np.testing.assert_array_equal(a.intervals, b.intervals)
    c = ours.copy()
    c.intervals[0, 0] = 9.0
    assert ours.intervals[0, 0] == 0.1 and ours == Timestamps(iv) and ours != c
    assert repr(ours) == repr(ref)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda p: p.stem + p.parent.name)
def test_seg_views_and_syntagmas_match_jax(grid):
    js = _j()[2]
    ours, ref = AudioSeg.load(grid), js.AudioSeg.load(grid)
    assert ours.phoneme_labels() == ref.phoneme_labels()
    np.testing.assert_array_equal(ours.phoneme_timestamps().intervals,
                                  ref.phoneme_timestamps().intervals)
    for name in ref.grid.tier_names:
        t_ours, t_ref = ours.tier(name), ref.tier(name)
        np.testing.assert_array_equal(t_ours.timestamps.intervals, t_ref.timestamps.intervals)
        assert t_ours.shift(0.25).intervals == t_ref.shift(0.25).intervals
        assert t_ours.window(0.3, 1.1).intervals == t_ref.window(0.3, 1.1).intervals
    parts, ref_parts = ours.split_into_syntagmas(), ref.split_into_syntagmas()
    assert len(parts) == len(ref_parts) >= 1
    for a, b in zip(parts, ref_parts):
        assert a.meta == b.meta and a.grid.dumps() == b.grid.dumps()
        assert (a.audio_chunk.file_path, a.audio_chunk.begin, a.audio_chunk.end) == \
            (b.audio_chunk.file_path, b.audio_chunk.begin, b.audio_chunk.end)


def test_seg_without_syntagmas_is_itself():
    js = _j()[2]
    seg = AudioSeg.load(GRIDS[0])
    seg.grid.tiers = [t for t in seg.grid.tiers if t.name != "syntagmas"]
    ref = js.AudioSeg.load(GRIDS[0])
    ref.grid.tiers = [t for t in ref.grid.tiers if t.name != "syntagmas"]
    assert seg.split_into_syntagmas() == [seg] and len(ref.split_into_syntagmas()) == 1


def test_seg_load_keywords_match_jax(tmp_path):
    ja, _, js, _ = _j()
    grid = GRIDS[0]
    wav = grid.parent / f"{grid.name.split('.')[0]}.wav"
    other = tmp_path / "other.wav"
    other.write_bytes(wav.read_bytes())
    for kw in ({}, {"audio_path": other}, {"load_audio": True},
               {"audio_path": other, "load_audio": True}):
        ours, ref = AudioSeg.load(grid, **kw), js.AudioSeg.load(grid, **kw)
        a, b = ours.audio_chunk, ref.audio_chunk
        assert (a.file_path, a.begin, a.end, a.sr, a.empty) == \
            (b.file_path, b.begin, b.end, b.sr, b.empty)
        if not a.empty:
            np.testing.assert_array_equal(a.data, b.data)


def test_audio_chunk_methods_match_jax():
    ja = _j()[0]
    wav = next(SEGS.rglob("*.wav"))
    for dtype in (np.float32, np.float64, None):
        ours = AudioChunk(file_path=wav, begin=0.1, end=0.6).load(sr=16000, dtype=dtype)
        ref = ja.AudioChunk(file_path=wav, begin=0.1, end=0.6).load(sr=16000, dtype=dtype)
        assert ours.data.dtype == ref.data.dtype and ours.sr == ref.sr
        np.testing.assert_array_equal(ours.data, ref.data)
    lazy, ref_lazy = AudioChunk(file_path=wav), ja.AudioChunk(file_path=wav)
    assert lazy.empty and ref_lazy.empty
    lazy.load(), ref_lazy.load()
    assert not lazy.empty and lazy.end == ref_lazy.end
    blob = ref.to_bytes()
    assert ours.to_bytes() == blob
    a, b = AudioChunk.from_bytes(blob), ja.AudioChunk.from_bytes(blob)
    np.testing.assert_array_equal(a.data, b.data)
    assert (a.sr, a.end) == (b.sr, b.end)
    c = ours.copy()
    c.data[:] = 0
    assert np.abs(ours.data).max() > 0 and (c.begin, c.end, c.sr) == (ours.begin, ours.end,
                                                                       ours.sr)
    enc = ours.mu_law_encode()
    np.testing.assert_array_equal(AudioChunk.mu_law_decode(enc, 255),
                                  ja.AudioChunk.mu_law_decode(enc, 255))
    np.testing.assert_array_equal(AudioChunk.mu_law_decode(enc[:50], 15),
                                  ja.AudioChunk.mu_law_decode(enc[:50], 15))


def test_codec_flags_match_jax():
    from speechflow_tpu.io import codecs as jcodecs

    assert (codecs.OGG_AVAILABLE, codecs.OPUS_AVAILABLE) == \
        (jcodecs.OGG_AVAILABLE, jcodecs.OPUS_AVAILABLE)
    libs = codecs.available()
    assert codecs.OGG_AVAILABLE == all(libs[f"lib{n}"] for n in
                                       ("ogg", "vorbis", "vorbisfile", "vorbisenc"))
    assert codecs.OPUS_AVAILABLE == libs["libopus"]


def test_tier_window_clips_and_reorigins():
    tier = Tier("t", [(0.0, 0.5, "a"), (0.5, 1.0, "b"), (1.0, 1.5, "c")])
    assert tier.window(0.25, 1.2).intervals == [(0.0, 0.25, "a"), (0.25, 0.75, "b"),
                                                (0.75, 0.95, "c")]
    assert tier.window(1.5, 2.0).intervals == []
