"""Spectral handlers (counterpart of ``speechflow_tpu/data/processors/spectral.py``,
the handlers of the TTS data config): the magnitude STFT, the mel
filterbank, log amplitude and its normalisation, energy, and YIN pitch
reconciled to the magnitude's frames. Each runs on the host through the
numpy DSP of ``np_dsp`` and records its parameters in the sample's
``transform_params``."""

from __future__ import annotations

import typing as tp

import numpy as np
from scipy import ndimage

from speechflow_torch.data.core.datasample import SpectrogramDataSample
from speechflow_torch.data.processors import np_dsp

__all__ = ["magnitude", "energy", "linear_to_mel", "amp_to_db", "normalize_mel", "pitch"]


def magnitude(ds: SpectrogramDataSample, n_fft: int = 1024, hop_len: int = 256,
              win_len: tp.Optional[int] = None, center: bool = True) -> SpectrogramDataSample:
    ds.magnitude = np_dsp.magnitude_np(ds.audio_chunk.waveform, n_fft, hop_len, win_len, center)
    ds.hop_len = hop_len
    ds.transform_params.setdefault("magnitude", {}).update(
        n_fft=n_fft, hop_len=hop_len, win_len=win_len or n_fft, center=center)
    return ds


def energy(ds: SpectrogramDataSample) -> SpectrogramDataSample:
    ds.energy = np_dsp.energy_np(ds.magnitude)
    return ds


def linear_to_mel(ds: SpectrogramDataSample, n_mels: int = 80, f_min: float = 0.0,
                  f_max: tp.Optional[float] = None,
                  librosa_htk: bool = False) -> SpectrogramDataSample:
    sr = ds.audio_chunk.sr if ds.audio_chunk is not None else ds.sample_rate
    ds.mel = np_dsp.linear_to_mel_np(ds.magnitude, sr, n_mels, f_min, f_max, librosa_htk)
    ds.transform_params.setdefault("linear_to_mel", {}).update(
        n_mels=n_mels, f_min=f_min, f_max=f_max, sample_rate=sr)
    return ds


def amp_to_db(ds: SpectrogramDataSample, multiplier: float = 1.0, a_min: float = 1e-5,
              a_max: tp.Optional[float] = None) -> SpectrogramDataSample:
    ds.mel = np_dsp.amp_to_db_np(ds.mel, multiplier, a_min, a_max)
    ds.transform_params.setdefault("amp_to_db", {})["min_level_db"] = \
        multiplier * float(np.log(a_min))
    return ds


def normalize_mel(ds: SpectrogramDataSample, max_abs_value: float = 4.0,
                  min_level_db: tp.Optional[float] = None) -> SpectrogramDataSample:
    if min_level_db is None:
        min_level_db = ds.get_param_val("min_level_db", np_dsp.MIN_LEVEL_DB)
    ds.mel = np_dsp.normalize_mel_np(ds.mel, max_abs_value, min_level_db)
    ds.transform_params.setdefault("normalize_mel", {}).update(
        max_abs_value=max_abs_value, min_level_db=min_level_db, mel_min_val=-max_abs_value)
    return ds


def pitch(ds: SpectrogramDataSample, f0_min: float = 80.0, f0_max: float = 880.0,
          frame_length: int = 2048, threshold: float = 0.2, method: str = "yin",
          crepe_ckpt: tp.Optional[str] = None,
          yingram_bins: int = 20) -> SpectrogramDataSample:
    """YIN F0 (0 where unvoiced), zoomed linearly to the magnitude's frame
    count when that differs. The JAX handler's other methods need models or
    transforms the port has not yet: ``crepe`` and ``yingram`` raise."""
    if method in ("crepe", "yingram"):
        raise NotImplementedError(f"pitch method {method!r} is not ported yet")
    if method != "yin":
        raise ValueError(f"unknown pitch method: {method!r}")
    hop_len = ds.get_param_val("hop_len", ds.hop_len or 256)
    f0 = np_dsp.yin_f0_np(ds.audio_chunk.waveform, ds.audio_chunk.sr, hop_len, frame_length,
                          f0_min, f0_max, threshold)
    if ds.magnitude is not None and f0.shape[0] != ds.magnitude.shape[0]:
        fmax = f0.max() if len(f0) else 0.0
        f0 = ndimage.zoom(f0, [ds.magnitude.shape[0] / f0.shape[0]], order=1)
        f0 = np.clip(f0, 0.0, fmax)[: ds.magnitude.shape[0]].astype(np.float32)
    ds.pitch = f0
    return ds
