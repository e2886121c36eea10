"""Spectral handlers (counterpart of ``speechflow_tpu/data/processors/spectral.py``,
the handlers of the TTS data config): the magnitude STFT, the mel
filterbank, log amplitude and its normalisation, energy, spectral flatness,
tilt and envelope, and pitch (YIN, CREPE or the yingram) reconciled to the
magnitude's frames. Each runs on the host
through the numpy DSP of ``np_dsp`` (CREPE's network on the GPU) and records
its parameters in the sample's ``transform_params``."""

from __future__ import annotations

import typing as tp

import numpy as np
from scipy import ndimage

from speechflow_torch.data.core.datasample import SpectrogramDataSample
from speechflow_torch.data.processors import handler, np_dsp

__all__ = ["magnitude", "energy", "spectral_flatness", "linear_to_mel", "amp_to_db",
           "normalize_mel", "pitch", "spectral_tilt", "spectral_envelope"]

#: the floor of ``amp_to_db``'s dB scale, under the reference's name
MIN_LEVEL_DB = np_dsp.MIN_LEVEL_DB


@handler(inputs={"audio_chunk"}, outputs={"magnitude", "hop_len"})
def magnitude(ds: SpectrogramDataSample, n_fft: int = 1024, hop_len: int = 256,
              win_len: tp.Optional[int] = None, center: bool = True) -> SpectrogramDataSample:
    ds.magnitude = np_dsp.magnitude_np(ds.audio_chunk.waveform, n_fft, hop_len, win_len, center)
    ds.hop_len = hop_len
    ds.transform_params.setdefault("magnitude", {}).update(
        n_fft=n_fft, hop_len=hop_len, win_len=win_len or n_fft, center=center)
    return ds


@handler(inputs={"magnitude"}, outputs={"energy"})
def energy(ds: SpectrogramDataSample) -> SpectrogramDataSample:
    ds.energy = np_dsp.energy_np(ds.magnitude)
    return ds


@handler(inputs={"magnitude"}, outputs={"spectral_flatness"})
def spectral_flatness(ds: SpectrogramDataSample) -> SpectrogramDataSample:
    ds.spectral_flatness = np_dsp.spectral_flatness_np(ds.magnitude)
    return ds


@handler(inputs={"magnitude"}, outputs={"mel"})
def linear_to_mel(ds: SpectrogramDataSample, n_mels: int = 80, f_min: float = 0.0,
                  f_max: tp.Optional[float] = None,
                  librosa_htk: bool = False) -> SpectrogramDataSample:
    sr = ds.audio_chunk.sr if ds.audio_chunk is not None else ds.sample_rate
    ds.mel = np_dsp.linear_to_mel_np(ds.magnitude, sr, n_mels, f_min, f_max, librosa_htk)
    ds.transform_params.setdefault("linear_to_mel", {}).update(
        n_mels=n_mels, f_min=f_min, f_max=f_max, sample_rate=sr)
    return ds


@handler(inputs={"mel"}, outputs={"mel"})
def amp_to_db(ds: SpectrogramDataSample, multiplier: float = 1.0, a_min: float = 1e-5,
              a_max: tp.Optional[float] = None) -> SpectrogramDataSample:
    ds.mel = np_dsp.amp_to_db_np(ds.mel, multiplier, a_min, a_max)
    ds.transform_params.setdefault("amp_to_db", {})["min_level_db"] = \
        multiplier * float(np.log(a_min))
    return ds


@handler(inputs={"mel"}, outputs={"mel"})
def normalize_mel(ds: SpectrogramDataSample, max_abs_value: float = 4.0,
                  min_level_db: tp.Optional[float] = None) -> SpectrogramDataSample:
    if min_level_db is None:
        min_level_db = ds.get_param_val("min_level_db", np_dsp.MIN_LEVEL_DB)
    ds.mel = np_dsp.normalize_mel_np(ds.mel, max_abs_value, min_level_db)
    ds.transform_params.setdefault("normalize_mel", {}).update(
        max_abs_value=max_abs_value, min_level_db=min_level_db, mel_min_val=-max_abs_value)
    return ds


_CREPE_CACHE: tp.Dict[str, tp.Any] = {}


@handler(inputs={"audio_chunk"}, outputs={"pitch"})
def pitch(ds: SpectrogramDataSample, f0_min: float = 80.0, f0_max: float = 880.0,
          frame_length: int = 2048, threshold: float = 0.2, method: str = "yin",
          crepe_ckpt: tp.Optional[str] = None,
          yingram_bins: int = 20) -> SpectrogramDataSample:
    """``method``: ``yin`` (host numpy), ``crepe`` (the trainable tracker of
    ``crepe_ckpt``, a ``save_crepe`` pickle of either package, loaded once per
    path and run on the GPU; f0 outside [f0_min, f0_max] becomes 0) or
    ``yingram`` (host numpy: the midi-scale CMNDF image with ``yingram_bins``
    bins a semitone, lags up to min(2047, frame_length - 1), clipped to
    [0, 4]). The result is zoomed linearly along time to the magnitude's frame
    count when that differs."""
    if method not in ("yin", "crepe", "yingram"):
        raise ValueError(f"unknown pitch method: {method!r}")
    if method == "crepe" and not crepe_ckpt:
        raise ValueError("pitch method 'crepe' requires crepe_ckpt")
    hop_len = ds.get_param_val("hop_len", ds.hop_len or 256)
    wav, sr = ds.audio_chunk.waveform, ds.audio_chunk.sr
    if method == "crepe":
        import torch

        from speechflow_torch.models.pitch import crepe_f0, load_crepe

        model = _CREPE_CACHE.get(crepe_ckpt)
        if model is None:
            model = _CREPE_CACHE[crepe_ckpt] = load_crepe(crepe_ckpt)
        x = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(
            next(model.parameters()).device)
        with torch.inference_mode():
            f0 = crepe_f0(model, x, sr=sr, hop_length=hop_len)[0].float().cpu().numpy()
        f0 = np.where((f0 < f0_min) | (f0 > float(f0_max)), 0.0, f0).astype(np.float32)
    elif method == "yin":
        f0 = np_dsp.yin_f0_np(wav, sr, hop_len, frame_length, f0_min, f0_max, threshold)
    else:
        f0 = np.clip(np_dsp.yingram_np(wav, sr, hop_len, frame_length,
                                       lag_max=min(2047, frame_length - 1),
                                       bins_per_semitone=yingram_bins), 0.0, 4.0)
    if ds.magnitude is not None and f0.shape[0] != ds.magnitude.shape[0]:
        fmax = f0.max() if len(f0) else 0.0
        zoom = [ds.magnitude.shape[0] / f0.shape[0]] + [1.0] * (f0.ndim - 1)
        f0 = ndimage.zoom(f0, zoom, order=1)
        f0 = np.clip(f0, 0.0, fmax)[: ds.magnitude.shape[0]].astype(np.float32)
    ds.pitch = f0
    return ds


@handler(inputs={"magnitude"}, outputs={"spectral_tilt"})
def spectral_tilt(ds: SpectrogramDataSample) -> SpectrogramDataSample:
    """Per frame, the least-squares slope of the dB spectrum rescaled to
    [0, n_bins - 1], as the frame's distance below the steepest frame's
    (``additional["spectral_tilt"]``, (T,))."""
    mag = np.maximum(ds.magnitude.astype(np.float64), 1e-8)
    n_bins = mag.shape[-1]
    db = 20.0 * np.log10(mag / 0.0002)
    mn, mx = db.min(axis=-1, keepdims=True), db.max(axis=-1, keepdims=True)
    scaled = (db - mn) * ((n_bins - 1) / np.maximum(mx - mn, 1e-6))
    x = np.arange(n_bins)
    xc = x - x.mean()
    slope = (scaled @ xc) / (xc @ xc)
    ds.additional["spectral_tilt"] = (slope.max() - slope).astype(np.float32)
    return ds


@handler(inputs={"magnitude"}, outputs={"spectral_envelope"})
def spectral_envelope(ds: SpectrogramDataSample, cutoff: int = 3,
                      n_bins: int = 80) -> SpectrogramDataSample:
    """The cepstrally liftered envelope (the first ``cutoff`` quefrencies, half
    of the next), in dB, scaled to [0, 1] over the utterance, Fourier-resampled
    to ``n_bins`` and clipped to [0, 1] (``additional["spectral_envelope"]``)."""
    from scipy import signal

    d = ds.magnitude.astype(np.float64)
    ceps = np.fft.irfft(np.log(d + 1e-6), axis=-1).real
    lifter = np.zeros(ceps.shape[-1])
    lifter[:cutoff] = 1.0
    if cutoff < len(lifter):
        lifter[cutoff] = 0.5
    env = np.abs(np.exp(np.fft.rfft(ceps * lifter, axis=-1)))
    env = 20 * np.log10(np.maximum(np.exp(-100 / 20 * np.log(10)), env)) - 16
    env = (env + 100) / 100
    env = env - env.min()
    env = env / max(env.max(), 1e-9)
    env = np.clip(signal.resample(env, n_bins, axis=-1), 0.0, 1.0)
    ds.additional["spectral_envelope"] = env.astype(np.float32)
    return ds
