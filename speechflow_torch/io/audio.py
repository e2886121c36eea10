"""Host-side audio container (counterpart of ``speechflow_tpu/io/audio.py``;
the part the eval interfaces and the audio handlers use).

An ``AudioChunk`` holds a float32 waveform and its rate, or the path of a
``.wav``, Ogg/Vorbis (``.ogg``, ``.oga``) or Ogg/Opus (``.opus``) file read (and
downmixed to mono) on ``load``, cut to the window [``begin``, ``end``) seconds
when one is given; ``load(sr)`` and ``resample`` go through
``scipy.signal.resample_poly``. ``save`` writes by extension: 16-bit PCM WAV,
Vorbis or Opus (``io/codecs.py``, the system's codec libraries through ctypes).
Numpy and scipy otherwise: audio files are host artifacts.

One difference from the JAX class: an array given as ``data`` is kept as it
is, so a batch of waveforms (B, N) stays one; the JAX class averages any 2-D
``data`` over its last axis, as it would a file's channels.
"""

from __future__ import annotations

import dataclasses
import io
import math
import typing as tp
import wave
from pathlib import Path

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

__all__ = ["AudioChunk", "AudioFormat"]

_OGG_SUFFIXES = (".ogg", ".oga", ".opus")
_INT_SCALE = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0}


def _to_float32(data: np.ndarray) -> np.ndarray:
    """PCM or float samples as float32 in [-1, 1]."""
    if data.dtype in _INT_SCALE:
        data = data / _INT_SCALE[data.dtype]
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    elif not np.issubdtype(data.dtype, np.floating):
        raise ValueError(f"unsupported sample type: {data.dtype}")
    return np.asarray(data, np.float32)


def _read(path: Path) -> tp.Tuple[int, np.ndarray]:
    """(rate, samples) of a WAV file or of an Ogg file, by its first packet."""
    if path.suffix.lower() not in _OGG_SUFFIXES:
        return wavfile.read(str(path))
    from speechflow_torch.io import codecs

    if codecs.ogg_codec_of(path) == "opus" or path.suffix.lower() == ".opus":
        data, sr = codecs.read_ogg_opus(path)
    else:
        data, sr = codecs.read_ogg_vorbis(path)
    return sr, data


class AudioFormat:
    """The file types ``AudioChunk`` reads and writes, by extension."""

    WAV = "wav"
    OGG = "ogg"
    OPUS = "opus"
    SUPPORTED = (WAV, OGG, OPUS, "oga")

    @staticmethod
    def check(path: tp.Union[str, Path]) -> bool:
        return Path(path).suffix.lower().lstrip(".") in AudioFormat.SUPPORTED


@dataclasses.dataclass
class AudioChunk:
    """A waveform (``data`` at rate ``sr``: (N,), or (B, N) for a batch) or a
    ``.wav`` file to read, from ``begin`` to ``end`` seconds (None: its end)."""

    file_path: tp.Optional[tp.Union[str, Path]] = None
    data: tp.Optional[np.ndarray] = None
    sr: tp.Optional[int] = None
    begin: float = 0.0
    end: tp.Optional[float] = None

    def __post_init__(self):
        if self.file_path is not None:
            self.file_path = Path(self.file_path)
        if self.data is not None:
            self.data = _to_float32(np.asarray(self.data))

    @property
    def empty(self) -> bool:
        """Whether no waveform is held yet."""
        return self.data is None

    @property
    def duration(self) -> float:
        """Seconds of audio (a file not yet read: its window, else the file's
        length: a WAV file mapped, not read; a compressed one decoded)."""
        if self.data is None and self.end is not None:
            return self.end - self.begin
        if self.data is None and self.file_path is not None:
            if self.file_path.suffix.lower() in _OGG_SUFFIXES:
                return self.load().duration
            sr, data = wavfile.read(str(self.file_path), mmap=True)
            return data.shape[0] / sr - self.begin
        return self.waveform.shape[-1] / self.sr

    @property
    def waveform(self) -> np.ndarray:
        if self.data is None:
            self.load()
        return self.data

    def __len__(self) -> int:
        """Samples (per waveform of a batch); 0 before a file is read."""
        return 0 if self.data is None else self.data.shape[-1]

    def load(self, sr: tp.Optional[int] = None, dtype=np.float32) -> "AudioChunk":
        """Read the file if there is no waveform yet (an open window ends where
        the file does), resample to ``sr``, cast to ``dtype`` (None: keep)."""
        if self.data is None:
            if self.file_path is None:
                raise ValueError("AudioChunk has neither data nor file_path")
            file_sr, data = _read(Path(self.file_path))
            data = _to_float32(np.atleast_1d(data))
            if data.ndim > 1:  # (N, channels) -> mono
                data = data.mean(axis=-1).astype(np.float32)
            b = int(round(self.begin * file_sr))
            e = len(data) if self.end is None else int(round(self.end * file_sr))
            self.data, self.sr = np.ascontiguousarray(data[b:e]), file_sr
            if self.end is None:
                self.end = self.begin + len(self.data) / file_sr
        if sr is not None and sr != self.sr:
            self.resample(sr)
        if dtype is not None and self.data.dtype != dtype:
            self.data = self.data.astype(dtype)
        return self

    def resample(self, sr: int) -> "AudioChunk":
        if self.sr != sr:
            g = math.gcd(int(sr), int(self.sr))
            self.data = resample_poly(self.waveform, sr // g, self.sr // g,
                                      axis=-1).astype(np.float32)
            self.sr = sr
        return self

    def save(self, path: tp.Union[str, Path], overwrite: bool = False) -> "AudioChunk":
        """Write the waveform, clipped to [-1, 1], by extension: ``.ogg`` /
        ``.oga`` Vorbis, ``.opus`` Opus at 48 kHz, else 16-bit PCM WAV."""
        path = Path(path)
        if path.exists() and not overwrite:
            raise FileExistsError(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        pcm = np.clip(self.waveform, -1.0, 1.0)
        suffix = path.suffix.lower()
        if suffix in (".ogg", ".oga", ".opus"):
            from speechflow_torch.io import codecs

            write = codecs.write_ogg_opus if suffix == ".opus" else codecs.write_ogg_vorbis
            write(path, pcm, int(self.sr))
        else:
            wavfile.write(str(path), int(self.sr), (pcm * 32767.0).astype(np.int16))
        return self

    def copy(self) -> "AudioChunk":
        """A chunk of the same window with its own copy of the waveform."""
        return AudioChunk(file_path=self.file_path,
                          data=None if self.data is None else self.data.copy(),
                          sr=self.sr, begin=self.begin, end=self.end)

    # -- in-place transforms of a mono waveform (the audio handlers') -------------

    def trim(self, begin: float = 0.0, end: tp.Optional[float] = None) -> "AudioChunk":
        """Keep [begin, end) seconds (samples rounded to the nearest)."""
        wav = self.waveform
        b = int(round(begin * self.sr))
        e = len(wav) if end is None else int(round(end * self.sr))
        self.data = wav[b:e]
        return self

    def pad(self, left_s: float = 0.0, right_s: float = 0.0) -> "AudioChunk":
        """Zeros before and after, in seconds (rounded to samples)."""
        self.data = np.pad(self.waveform, (int(round(left_s * self.sr)),
                                           int(round(right_s * self.sr))))
        return self

    def multiple(self, hop: int, pad_value: float = 0.0) -> "AudioChunk":
        """Pad at the end to a multiple of ``hop`` samples."""
        rem = (-len(self.waveform)) % hop
        if rem:
            self.data = np.pad(self.data, (0, rem), constant_values=pad_value)
        return self

    def volume(self, gain: float) -> "AudioChunk":
        self.data = (self.waveform * gain).astype(np.float32)
        return self

    def preemphasis(self, coeff: float = 0.97) -> "AudioChunk":
        """y[0] = x[0], y[n] = x[n] - coeff x[n-1]."""
        wav = self.waveform
        self.data = np.concatenate([wav[:1], wav[1:] - coeff * wav[:-1]]).astype(np.float32)
        return self

    def mu_law_encode(self, mu: int = 255) -> np.ndarray:
        """The waveform, clipped to [-1, 1], mu-law companded (not quantised)."""
        wav = np.clip(self.waveform, -1.0, 1.0)
        return (np.sign(wav) * np.log1p(mu * np.abs(wav)) / np.log1p(mu)).astype(np.float32)

    @staticmethod
    def mu_law_decode(enc: np.ndarray, mu: int = 255) -> np.ndarray:
        """The inverse of ``mu_law_encode``."""
        return (np.sign(enc) * ((1 + mu) ** np.abs(enc) - 1) / mu).astype(np.float32)

    def normalize(self, peak: float = 0.95) -> "AudioChunk":
        """Scale the peak magnitude to ``peak`` (silence is left as it is)."""
        wav = self.waveform
        m = np.abs(wav).max()
        if m > 0:
            self.data = (wav * (peak / m)).astype(np.float32)
        return self

    def to_bytes(self) -> bytes:
        """The waveform as a mono 16-bit PCM WAV file, clipped to [-1, 1]."""
        buf = io.BytesIO()
        pcm = (np.clip(self.waveform, -1.0, 1.0) * 32767.0).astype(np.int16)
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(int(self.sr))
            w.writeframes(pcm.tobytes())
        return buf.getvalue()

    @staticmethod
    def from_bytes(blob: bytes) -> "AudioChunk":
        """A chunk of a 16-bit PCM WAV file's bytes (channels averaged)."""
        with wave.open(io.BytesIO(blob), "rb") as w:
            sr, width, ch = w.getframerate(), w.getsampwidth(), w.getnchannels()
            raw = w.readframes(w.getnframes())
        if width != 2:
            raise ValueError("only 16-bit PCM supported in from_bytes")
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
        if ch > 1:
            data = data.reshape(-1, ch).mean(axis=-1)
        return AudioChunk(data=data, sr=sr, end=len(data) / sr)
