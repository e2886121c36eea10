"""The corpus preparers (``speechflow_torch/annotator/prepare_datasets.py``) against
the JAX package's, over the four layouts of ``tests/test_prepare_datasets.py``
built twice from the same seeded tones: every file each package leaves in its
tree is held equal (names and bytes; the wavs converted from Ogg, and golos'
loudness-scaled wavs, sample for sample), as are the counts. Also the FLAC
error, a golos sample rate below 16 kHz, the CLI, and golos in a process pool,
which JAX's cannot pickle (ROADMAP §3)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from speechflow_torch.annotator import prepare_datasets as PD
from speechflow_torch.io.audio import AudioChunk

torch.set_num_threads(1)
SR = 24000


def _tone(seconds=0.2, freq=220.0, amp=0.1, sr=SR):
    t = np.arange(int(sr * seconds)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _write_wav(path, wav=None, sr=SR):
    AudioChunk(data=_tone() if wav is None else wav, sr=sr).save(path)


def _ljspeech(root: Path):
    for i in range(3):
        _write_wav(root / "wavs" / f"LJ001-{i:04d}.wav", _tone(freq=200.0 + 10 * i))
    lines = [f"LJ001-{i:04d}|Raw {i}|Normalized text {i}." for i in range(4)] + [""]
    (root / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")


def _libri_tts(root: Path):
    utt = root / "train-clean" / "19" / "198"
    _write_wav(utt / "19_198_000000.wav")
    (utt / "19_198_000000.normalized.txt").write_text("Hello there.")
    (utt / "19_198_000000.original.txt").write_text("HELLO THERE")
    AudioChunk(data=_tone(0.3, 330.0), sr=SR).save(utt / "19_198_000001.opus")


def _hifi_tts(root: Path):
    _write_wav(root / "audio" / "0.wav")
    AudioChunk(data=_tone(0.3, freq=330.0), sr=SR).save(root / "audio" / "1.ogg")
    manifest = [{"audio_filepath": "audio/0.wav", "text_normalized": "Zero."},
                {"audio_filepath": "audio/1.ogg", "text_normalized": "One."},
                {"audio_filepath": "audio/missing.wav", "text_normalized": "Nope."}]
    (root / "manifest.json").write_text("\n".join(json.dumps(m) for m in manifest)
                                        + "\nnot json\n", encoding="utf-8")


def _golos(root: Path):
    _write_wav(root / "crowd" / "0.wav", _tone(amp=0.01))
    _write_wav(root / "crowd" / "1.wav", _tone(amp=0.5))
    _write_wav(root / "farfield" / "2.wav", _tone(amp=0.2, freq=300.0))
    _write_wav(root / "farfield" / "3.wav", _tone(amp=0.2, sr=8000), sr=8000)  # too low a rate
    for folder, rows in (("crowd", [("0.wav", "quiet utterance"), ("1.wav", "loud utterance")]),
                         ("farfield", [("2.wav", "far"), ("3.wav", "narrow band"),
                                       ("9.wav", "missing")])):
        (root / folder / "manifest.jsonl").write_text(
            "\n".join(json.dumps({"audio_filepath": a, "text": t}) for a, t in rows),
            encoding="utf-8")


LAYOUTS = {"ljspeech": _ljspeech, "libri_tts": _libri_tts, "hifi_tts": _hifi_tts,
           "golos": _golos}


def _tree(root: Path) -> dict:
    """Relative path -> bytes (text and wav headers), and each wav's samples."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            rel = str(p.relative_to(root))
            data = p.read_bytes()
            # golos' all_meta.txt names the files by their absolute paths
            out[rel] = data.replace(str(root).encode(), b"<root>")
            if p.suffix == ".wav":
                out[rel + ":samples"] = AudioChunk(file_path=p).load().waveform
    return out


@pytest.mark.parametrize("corpus", sorted(LAYOUTS))
def test_preparers_write_what_jax_writes(corpus, tmp_path):
    from speechflow_tpu.annotator import prepare_datasets as JPD

    counts, trees = [], []
    for mod, sub in ((PD, "port"), (JPD, "jax")):
        root = tmp_path / sub / corpus
        LAYOUTS[corpus](root)
        counts.append(getattr(mod, f"prepare_{corpus}")(root))
        trees.append(_tree(root))
    assert counts[0] == counts[1] == {"ljspeech": 3, "libri_tts": 1, "hifi_tts": 2,
                                      "golos": 3}[corpus]
    assert set(trees[0]) == set(trees[1])
    for k in trees[1]:
        if k.endswith(":samples"):
            np.testing.assert_array_equal(trees[0][k], trees[1][k], err_msg=k)
        else:
            assert trees[0][k] == trees[1][k], k
    names = set(trees[0])
    if corpus == "hifi_tts":
        assert "audio/1.wav" in names and "audio/1.ogg" not in names
    if corpus == "libri_tts":
        assert "train-clean/19/198/19_198_000001.wav" in names
    if corpus == "golos":
        assert trees[0]["all_meta.txt"].decode().splitlines()[0].endswith("|quiet utterance")
        for i in range(3):
            wav = trees[0][f"{'crowd' if i < 2 else 'farfield'}/{i}.wav:samples"]
            assert 20 * np.log10(np.sqrt(np.mean(wav.astype(np.float64) ** 2))) == \
                pytest.approx(-30.0, abs=0.01)
        assert "farfield/3.txt" not in names


def test_flac_raises_as_jax(tmp_path):
    from speechflow_tpu.annotator import prepare_datasets as JPD

    f = tmp_path / "x.flac"
    f.write_bytes(b"fLaC....")
    for mod in (PD, JPD):
        with pytest.raises(RuntimeError, match="no FLAC decoder"):
            mod.convert_to_wav(f)
        with pytest.raises(RuntimeError, match="unsupported audio format"):
            mod.convert_to_wav(tmp_path / "x.mp3")


def test_cli_matches_jax(tmp_path, capsys):
    from speechflow_tpu.annotator import prepare_datasets as JPD

    for mod, sub in ((PD, "port"), (JPD, "jax")):
        root = tmp_path / sub
        _ljspeech(root)
        assert mod.main(["ljspeech", "-d", str(root)]) == 3
        assert capsys.readouterr().out == "DONE! Prepared 3 files\n"
        _golos(root / "golos")
        assert mod.main(["golos", "-d", str(root / "golos"), "-nproc", "0"]) == 3
        assert capsys.readouterr().out == "DONE! Prepared 3 files\n"


def test_golos_in_a_pool_where_jax_cannot_pickle_its_function(tmp_path):
    """With ``n_processes`` 2 and more than one chunk of 100, JAX's golos hands the
    spawned pool a local function, which does not pickle; the port's pickles and
    gives the files the one-process run gives."""
    from speechflow_tpu.annotator import prepare_datasets as JPD

    trees = []
    for sub, n_proc in (("pool", 2), ("one", 0)):
        root = tmp_path / sub
        rows = []
        for i in range(101):
            _write_wav(root / "crowd" / f"{i}.wav", _tone(0.02, amp=0.01 + 0.001 * i))
            rows.append(json.dumps({"audio_filepath": f"{i}.wav", "text": f"utterance {i}"}))
        (root / "crowd" / "manifest.jsonl").write_text("\n".join(rows), encoding="utf-8")
        assert PD.prepare_golos(root, n_processes=n_proc) == 101
        trees.append(_tree(root))
    assert set(trees[0]) == set(trees[1])
    for k in trees[1]:
        if k.endswith(":samples"):
            np.testing.assert_array_equal(trees[0][k], trees[1][k], err_msg=k)
        else:
            assert trees[0][k] == trees[1][k], k
    with pytest.raises(AttributeError, match="local object '_golos_one"):
        JPD.prepare_golos(tmp_path / "one", n_processes=2)
