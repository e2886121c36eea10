"""Ogg/Vorbis and Ogg/Opus in the port (``speechflow_torch.io.codecs`` and
``io.audio.AudioChunk``) against the JAX package's readers and writers: the
committed fixtures decode to JAX's samples exactly, the port's writes decode
back to the waveform (and JAX reads them alike), the container's CRC and pages
are JAX's, and an absent library raises naming it."""

from pathlib import Path

import numpy as np
import pytest
import torch

from speechflow_torch.io import codecs
from speechflow_torch.io.audio import AudioChunk

torch.set_num_threads(1)
DATA = Path(__file__).resolve().parent / "data"
SR = 24000


def _meta() -> dict:
    return dict(line.split("=", 1) for line in
                (DATA / "fixture_meta.txt").read_text().splitlines() if "=" in line)


def _tone(n: int = 2 * SR) -> np.ndarray:
    t = np.arange(n) / SR
    return (0.5 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 660 * t)
            ).astype(np.float32)


def _snr(decoded: np.ndarray, original: np.ndarray) -> float:
    """SNR in dB after the best lag within 2000 samples (codec delay)."""
    n = min(len(decoded), len(original)) - 2000
    lag = int(np.argmax([np.dot(decoded[k:k + n], original[:n]) for k in range(2000)]))
    a, b = decoded[lag:lag + n], original[:n]
    return float(10 * np.log10(np.sum(b ** 2) / (np.sum((a - b) ** 2) + 1e-12)))


@pytest.mark.parametrize("name,codec", [("fixture.ogg", "vorbis"), ("fixture.opus", "opus")])
def test_fixture_reads_exactly_as_jax(name, codec):
    """The committed fixture, raw and through ``AudioChunk.load`` (with a
    resample to the fixture's rate), equals JAX's read bit for bit."""
    from speechflow_tpu.io import AudioChunk as JChunk
    from speechflow_tpu.io import codecs as jcodecs

    path = DATA / name
    assert codecs.ogg_codec_of(path) == jcodecs.ogg_codec_of(path) == codec
    read, jread = ((codecs.read_ogg_vorbis, jcodecs.read_ogg_vorbis) if codec == "vorbis"
                   else (codecs.read_ogg_opus, jcodecs.read_ogg_opus))
    (wav, sr), (jwav, jsr) = read(path), jread(path)
    assert sr == jsr and wav.dtype == jwav.dtype == np.float32
    np.testing.assert_array_equal(wav, jwav)
    meta = _meta()
    ours = AudioChunk(file_path=path).load(sr=int(meta["sr"]))
    ref = JChunk(file_path=path).load(sr=int(meta["sr"]))
    np.testing.assert_array_equal(ours.data, ref.data)
    assert ours.sr == ref.sr == int(meta["sr"])
    assert abs(ours.duration - float(meta["seconds"])) < 0.05
    assert AudioChunk(file_path=path).duration == pytest.approx(len(wav) / sr)


@pytest.mark.parametrize("suffix,min_snr", [(".ogg", 15.0), (".opus", 10.0)])
def test_write_round_trips(tmp_path, suffix, min_snr):
    """``AudioChunk.save`` -> ``load``: compressed, the waveform back within the
    codec's SNR, and JAX's reader decodes the port's file to the same samples."""
    from speechflow_tpu.io import AudioChunk as JChunk

    wav = _tone()
    path = tmp_path / f"a{suffix}"
    AudioChunk(data=wav, sr=SR).save(path)
    assert path.stat().st_size < wav.nbytes / 4
    back = AudioChunk(file_path=path).load(sr=SR)
    assert back.sr == SR and _snr(back.data, wav) > min_snr
    np.testing.assert_array_equal(back.data, JChunk(file_path=path).load(sr=SR).data)
    with pytest.raises(FileExistsError):
        AudioChunk(data=wav, sr=SR).save(path)


def test_opus_pages_and_crc_are_jax_s():
    """The pure-Python Ogg layer: the CRC-32 and a page's bytes equal JAX's, and
    the fixture's packets reassemble alike."""
    from speechflow_tpu.io import codecs as jcodecs

    rng = np.random.default_rng(0)
    blob = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    assert codecs._ogg_crc(blob) == jcodecs._ogg_crc(blob)
    segs = [blob[:300], blob[300:301], blob[301:3000]]
    assert codecs._ogg_page_bytes(segs, 7, 3, 960, 4) == jcodecs._ogg_page_bytes(segs, 7, 3,
                                                                                  960, 4)
    data = (DATA / "fixture.opus").read_bytes()
    assert list(codecs._ogg_packets(data)) == list(jcodecs._ogg_packets(data))


@pytest.mark.parametrize("missing,call", [
    ("vorbisfile", lambda p: codecs.read_ogg_vorbis(DATA / "fixture.ogg")),
    ("vorbisenc", lambda p: codecs.write_ogg_vorbis(p / "a.ogg", _tone(SR), SR)),
    ("opus", lambda p: AudioChunk(file_path=DATA / "fixture.opus").load()),
    ("opus", lambda p: AudioChunk(data=_tone(SR), sr=SR).save(p / "a.opus")),
])
def test_absent_library_raises_by_name(monkeypatch, tmp_path, missing, call):
    monkeypatch.setitem(codecs.LIBS, missing, None)
    assert codecs.available()[f"lib{missing}"] is False
    with pytest.raises(RuntimeError, match=f"lib{missing}"):
        call(tmp_path)
