"""Mel filterbank and dB / normalisation ops (counterpart of
``speechflow_tpu/ops/mel.py``).

The filterbank is the JAX package's librosa-compatible numpy design (Slaney
or HTK mel scale, Slaney area normalisation), built on the host, cached, and
applied as one matrix product. ``amp_to_db`` is the natural log of the
magnitude clipped below at ``a_min``; ``normalize_mel`` maps
[min_level_db, 0] onto [-max_abs, max_abs], clipped at the bottom only.
"""

from __future__ import annotations

import functools
import typing as tp

import numpy as np
import torch

__all__ = ["mel_filterbank", "linear_to_mel", "mel_to_linear", "amp_to_db", "db_to_amp",
           "normalize_mel", "denormalize_mel", "MIN_LEVEL_DB"]

#: default min level in natural-log space: ln(1e-5)
MIN_LEVEL_DB = float(np.log(1e-5))


def _hz_to_mel(freq: np.ndarray, htk: bool = False) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3  # Slaney: linear below 1 kHz, logarithmic above
    mel = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = freq >= min_log_hz
    return np.where(above, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz)
                    / logstep, mel)


def _mel_to_hz(mel: np.ndarray, htk: bool = False) -> np.ndarray:
    mel = np.asarray(mel, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freq = f_min + f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = mel >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (mel - min_log_mel)), freq)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int = 80, fmin: float = 0.0,
                   fmax: tp.Optional[float] = None, htk: bool = False,
                   norm: tp.Optional[str] = "slaney") -> np.ndarray:
    """(n_mels, n_fft//2 + 1) triangular filterbank, float32 (numpy, cached)."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin), htk), _hz_to_mel(np.array(fmax), htk),
                          n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        weights *= (2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)  # cached: a normal tensor even when first built in inference
def _matrix_on(key: tuple, inverse: bool, rcond: float, device: str) -> torch.Tensor:
    """The filterbank's transpose (or its pseudo-inverse's), on ``device``."""
    fb = mel_filterbank(*key)
    m = np.linalg.pinv(fb, rcond=rcond).astype(np.float32) if inverse else fb
    return torch.from_numpy(np.ascontiguousarray(m.T)).to(device)


def linear_to_mel(mag: torch.Tensor, sr: int, n_mels: int = 80, fmin: float = 0.0,
                  fmax: tp.Optional[float] = None, htk: bool = False) -> torch.Tensor:
    """(..., T, n_bins) magnitude -> (..., T, n_mels)."""
    n_fft = (mag.shape[-1] - 1) * 2
    fb_t = _matrix_on((sr, n_fft, n_mels, fmin, fmax, htk), False, 0.0, str(mag.device))
    return torch.matmul(mag, fb_t.to(mag.dtype))


def mel_to_linear(mel: torch.Tensor, sr: int, n_fft: int, fmin: float = 0.0,
                  fmax: tp.Optional[float] = None, htk: bool = False,
                  rcond: float = 1e-5) -> torch.Tensor:
    """Pseudo-inverse mel -> linear magnitude, clipped below at ``fmin``."""
    inv_t = _matrix_on((sr, n_fft, mel.shape[-1], fmin, fmax, htk), True, rcond,
                       str(mel.device))
    return torch.clamp(torch.matmul(mel, inv_t.to(mel.dtype)), min=fmin)


def amp_to_db(x: torch.Tensor, multiplier: float = 1.0, a_min: float = 1e-5,
              a_max: tp.Optional[float] = None) -> torch.Tensor:
    """log(clip(x, a_min, a_max)) · multiplier. The clip is ``maximum`` /
    ``minimum`` against a scalar, whose gradient at a tie is split in half as
    ``jnp.clip``'s is (``torch.clamp`` passes all of it)."""
    out = torch.maximum(x, x.new_tensor(a_min))
    if a_max is not None:
        out = torch.minimum(out, out.new_tensor(a_max))
    out = torch.log(out)
    return out * multiplier if multiplier != 1.0 else out


def db_to_amp(x: torch.Tensor, multiplier: float = 1.0) -> torch.Tensor:
    return torch.exp(x / multiplier if multiplier != 1.0 else x)


def normalize_mel(mel_db: torch.Tensor, max_abs_value: float = 4.0,
                  min_level_db: float = MIN_LEVEL_DB) -> torch.Tensor:
    out = (2 * max_abs_value) * ((mel_db - min_level_db) / (-min_level_db)) - max_abs_value
    return torch.clamp(out, min=-max_abs_value)


def denormalize_mel(mel_norm: torch.Tensor, max_abs_value: float = 4.0,
                    min_level_db: float = MIN_LEVEL_DB) -> torch.Tensor:
    clipped = torch.clamp(mel_norm, min=-max_abs_value)
    return (clipped + max_abs_value) * (-min_level_db) / (2 * max_abs_value) + min_level_db
