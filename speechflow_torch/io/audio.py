"""Host-side audio container (counterpart of ``speechflow_tpu/io/audio.py``;
the part the eval interfaces use).

An ``AudioChunk`` holds a float32 waveform and its rate, or the path of a
``.wav`` file read (and downmixed to mono) on ``load``; ``load(sr)`` and
``resample`` go through ``scipy.signal.resample_poly``. Numpy and scipy
only: audio files are host artifacts.

One difference from the JAX class: an array given as ``data`` is kept as it
is, so a batch of waveforms (B, N) stays one; the JAX class averages any 2-D
``data`` over its last axis, as it would a file's channels.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp
from pathlib import Path

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

__all__ = ["AudioChunk"]

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


@dataclasses.dataclass
class AudioChunk:
    """A waveform (``data`` at rate ``sr``: (N,), or (B, N) for a batch) or a
    ``.wav`` file to read."""

    file_path: tp.Optional[tp.Union[str, Path]] = None
    data: tp.Optional[np.ndarray] = None
    sr: tp.Optional[int] = None

    def __post_init__(self):
        if self.file_path is not None:
            self.file_path = Path(self.file_path)
        if self.data is not None:
            self.data = _to_float32(np.asarray(self.data))

    @property
    def duration(self) -> float:
        """Seconds of audio (the waveform is read from the file if needed)."""
        return self.waveform.shape[-1] / self.sr

    @property
    def waveform(self) -> np.ndarray:
        if self.data is None:
            self.load()
        return self.data

    def __len__(self) -> int:
        """Samples (per waveform of a batch); 0 before a file is read."""
        return 0 if self.data is None else self.data.shape[-1]

    def load(self, sr: tp.Optional[int] = None) -> "AudioChunk":
        """Read the file if there is no waveform yet, then resample to ``sr``."""
        if self.data is None:
            if self.file_path is None:
                raise ValueError("AudioChunk has neither data nor file_path")
            file_sr, data = wavfile.read(str(self.file_path))
            data = _to_float32(np.atleast_1d(data))
            if data.ndim > 1:  # (N, channels) -> mono
                data = data.mean(axis=-1).astype(np.float32)
            self.data, self.sr = np.ascontiguousarray(data), file_sr
        if sr is not None and sr != self.sr:
            self.resample(sr)
        return self

    def resample(self, sr: int) -> "AudioChunk":
        if self.sr != sr:
            g = math.gcd(int(sr), int(self.sr))
            self.data = resample_poly(self.waveform, sr // g, self.sr // g,
                                      axis=-1).astype(np.float32)
            self.sr = sr
        return self
