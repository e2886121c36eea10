"""Waveform handlers (counterpart of ``speechflow_tpu/data/processors/audio.py``,
the handlers of the vocoder's data path). Each takes an ``AudioDataSample``
and changes its ``audio_chunk`` in place."""

from __future__ import annotations

import typing as tp

import numpy as np

from speechflow_torch.data.core.datasample import AudioDataSample

__all__ = ["load_audio", "trim_audio", "random_chunk", "pad_audio", "multiple_audio",
           "volume_normalize"]


def load_audio(ds: AudioDataSample, sample_rate: tp.Optional[int] = None) -> AudioDataSample:
    ds.audio_chunk.load(sr=sample_rate)
    ds.sample_rate = ds.audio_chunk.sr
    ds.transform_params.setdefault("load_audio", {})["sample_rate"] = ds.sample_rate
    return ds


def trim_audio(ds: AudioDataSample, begin: float = 0.0,
               end: tp.Optional[float] = None) -> AudioDataSample:
    ds.audio_chunk.trim(begin, end)
    return ds


def random_chunk(ds: AudioDataSample, chunk_duration: float = 1.0,
                 seed: tp.Optional[int] = None) -> AudioDataSample:
    """A random crop of ``chunk_duration`` seconds (``np.random.default_rng(seed)``:
    fresh entropy per call without a seed); a shorter sample is zero-padded."""
    dur = ds.audio_chunk.duration
    if dur > chunk_duration:
        begin = float(np.random.default_rng(seed).uniform(0.0, dur - chunk_duration))
        ds.audio_chunk.trim(begin, begin + chunk_duration)
    else:
        ds.audio_chunk.pad(0.0, chunk_duration - dur)
    return ds


def pad_audio(ds: AudioDataSample, left_s: float = 0.0, right_s: float = 0.0
              ) -> AudioDataSample:
    ds.audio_chunk.pad(left_s, right_s)
    return ds


def multiple_audio(ds: AudioDataSample, hop: int = 256) -> AudioDataSample:
    ds.audio_chunk.multiple(hop)
    return ds


def volume_normalize(ds: AudioDataSample, peak: float = 0.95) -> AudioDataSample:
    ds.audio_chunk.normalize(peak)
    return ds
