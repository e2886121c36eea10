"""Host-side (numpy) DSP of the spectral handlers (counterpart of the
functions of ``speechflow_tpu/data/processors/np_dsp.py`` that the TTS data
config's handlers use): the same framing, windows, filterbank and
normalisation as the device ops, so features made by the data workers on
the host match the ones the port computes on the card. The filterbank is
the port's own ``ops.mel.mel_filterbank``."""

from __future__ import annotations

import typing as tp

import numpy as np

from speechflow_torch.ops.mel import MIN_LEVEL_DB, mel_filterbank

__all__ = ["hann_window_np", "stft_np", "magnitude_np", "linear_to_mel_np",
           "amp_to_db_np", "normalize_mel_np", "denormalize_mel_np", "energy_np",
           "spectral_flatness_np", "yin_f0_np", "yingram_np", "acf_f0_np", "MIN_LEVEL_DB"]


def hann_window_np(win_len: int) -> np.ndarray:
    n = np.arange(win_len)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_len)).astype(np.float64)


def _frame_np(x: np.ndarray, frame_length: int, hop: int) -> np.ndarray:
    n_frames = 1 + (len(x) - frame_length) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame_length)[None, :]
    return x[idx]


def stft_np(
    x: np.ndarray,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: tp.Optional[int] = None,
    center: bool = True,
) -> np.ndarray:
    win_length = win_length or n_fft
    window = hann_window_np(win_length)
    if win_length < n_fft:
        lp = (n_fft - win_length) // 2
        window = np.pad(window, (lp, n_fft - win_length - lp))
    if center:
        pad = n_fft // 2
        x = np.pad(x, (pad, pad), mode="reflect")
    frames = _frame_np(x.astype(np.float64), n_fft, hop_length) * window
    return np.fft.rfft(frames, n=n_fft, axis=-1)  # (n_frames, n_bins)


def magnitude_np(x: np.ndarray, n_fft: int = 1024, hop_length: int = 256,
                 win_length: tp.Optional[int] = None, center: bool = True) -> np.ndarray:
    return np.abs(stft_np(x, n_fft, hop_length, win_length, center)).astype(np.float32)


def linear_to_mel_np(mag: np.ndarray, sr: int, n_mels: int = 80,
                     fmin: float = 0.0, fmax: tp.Optional[float] = None,
                     htk: bool = False) -> np.ndarray:
    n_fft = (mag.shape[-1] - 1) * 2
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk)
    return (mag @ fb.T).astype(np.float32)


def amp_to_db_np(x: np.ndarray, multiplier: float = 1.0, a_min: float = 1e-5,
                 a_max: tp.Optional[float] = None) -> np.ndarray:
    out = np.log(np.clip(x, a_min, a_max))
    if multiplier != 1.0:
        out = out * multiplier
    return out.astype(np.float32)


def normalize_mel_np(mel_db: np.ndarray, max_abs_value: float = 4.0,
                     min_level_db: float = MIN_LEVEL_DB) -> np.ndarray:
    out = (2 * max_abs_value) * ((mel_db - min_level_db) / (-min_level_db)) - max_abs_value
    return np.clip(out, -max_abs_value, None).astype(np.float32)


def denormalize_mel_np(mel_norm: np.ndarray, max_abs_value: float = 4.0,
                       min_level_db: float = MIN_LEVEL_DB) -> np.ndarray:
    """The inverse of ``normalize_mel_np`` (values below -max_abs_value clipped)."""
    clipped = np.clip(mel_norm, -max_abs_value, None)
    return ((clipped + max_abs_value) * (-min_level_db) / (2 * max_abs_value)
            + min_level_db).astype(np.float32)


def energy_np(mag: np.ndarray) -> np.ndarray:
    return np.linalg.norm(mag, axis=-1).astype(np.float32)


def spectral_flatness_np(mag: np.ndarray, power: float = 2.0, amin: float = 1e-10
                         ) -> np.ndarray:
    """1 - clip(100 * geometric / arithmetic mean of the power spectrum, 0, 0.99)."""
    s = np.maximum(mag, amin) ** power
    gmean = np.exp(np.mean(np.log(s), axis=-1))
    amean = np.mean(s, axis=-1)
    return (1.0 - np.clip(gmean / amean * 100.0, 0.0, 0.99)).astype(np.float32)


def yin_f0_np(
    x: np.ndarray,
    sr: int,
    hop_length: int = 256,
    frame_length: int = 2048,
    f0_min: float = 80.0,
    f0_max: float = 880.0,
    threshold: float = 0.2,
) -> np.ndarray:
    """Numpy mirror of ops.yin_f0 (same framing/CMNDF/trough logic)."""
    tau_min = max(2, int(np.floor(sr / f0_max)))
    tau_max = int(np.ceil(sr / f0_min))
    w = frame_length
    pad = w // 2
    xp = np.pad(x, (pad, pad), mode="reflect")
    frames = _frame_np(xp.astype(np.float64), w, hop_length)
    half = w // 2
    nfft = int(2 ** np.ceil(np.log2(w + tau_max)))

    taus = np.arange(tau_max + 1)
    sq = frames * frames
    csum = np.concatenate([np.zeros_like(sq[:, :1]), np.cumsum(sq, axis=-1)], axis=-1)
    e_tau = csum[:, taus + half] - csum[:, taus]
    e0 = e_tau[:, :1]

    spec_h = np.fft.rfft(frames[:, :half], n=nfft, axis=-1)
    cross = np.fft.irfft(np.conj(spec_h) * np.fft.rfft(frames, n=nfft, axis=-1), n=nfft, axis=-1)
    acf_h = cross[:, : tau_max + 1]

    d = np.maximum(e0 + e_tau - 2.0 * acf_h, 0.0)
    cum = np.cumsum(d[:, 1:], axis=-1)
    dprime = d[:, 1:] * taus[1:] / np.maximum(cum, 1e-12)
    dprime = np.concatenate([np.ones_like(d[:, :1]), dprime], axis=-1)

    lag_mask = (taus >= tau_min) & (taus <= tau_max)
    dp = np.where(lag_mask, dprime, np.inf)

    left = np.concatenate([np.full_like(dp[:, :1], np.inf), dp[:, :-1]], axis=-1)
    right = np.concatenate([dp[:, 1:], np.full_like(dp[:, :1], np.inf)], axis=-1)
    cand = (dp <= left) & (dp <= right) & (dp < threshold)
    first_cand = np.argmax(cand, axis=-1)
    any_cand = cand.any(axis=-1)
    tau_star = np.where(any_cand, first_cand, np.argmin(dp, axis=-1))

    tm1 = np.clip(tau_star - 1, 0, tau_max)
    tp1 = np.clip(tau_star + 1, 0, tau_max)
    rows = np.arange(len(tau_star))
    y0, y1, y2 = dprime[rows, tm1], dprime[rows, tau_star], dprime[rows, tp1]
    denom = y0 - 2 * y1 + y2
    delta = np.where(np.abs(denom) > 1e-12, 0.5 * (y0 - y2) / denom, 0.0)
    tau_ref = tau_star + np.clip(delta, -0.5, 0.5)

    f0 = sr / np.maximum(tau_ref, 1.0)
    dp_min = dp[rows, tau_star]
    frame_rms = np.sqrt(np.mean(frames * frames, axis=-1))
    voiced = (dp_min < max(threshold, 0.35)) & (frame_rms > 1e-4)
    f0 = np.where(voiced, f0, 0.0)
    f0 = np.where((f0 >= f0_min) & (f0 <= f0_max), f0, 0.0)
    return f0.astype(np.float32)


def yingram_np(x: np.ndarray, sr: int, hop_length: int = 256, frame_length: int = 2048,
               lag_min: int = 22, lag_max: int = 2047, bins_per_semitone: int = 20
               ) -> np.ndarray:
    """Numpy mirror of ``ops.pitch.yingram`` (same framing, CMNDF and midi grid)
    in float64: (T,) waveform -> (1 + T // hop, n_bins) float32."""
    from speechflow_torch.ops.pitch import midi_to_lag, yingram_midi_range

    if lag_max >= frame_length:
        raise ValueError(f"yingram requires lag_max < frame_length, got lag_max={lag_max} "
                         f"frame_length={frame_length} (raise frame_length or lower lag_max)")
    w = frame_length
    pad = w // 2
    frames = _frame_np(np.pad(x, (pad, pad), mode="reflect").astype(np.float64), w,
                       hop_length)
    nfft = int(2 ** np.ceil(np.log2(w + lag_max)))
    spec = np.fft.rfft(frames, n=nfft, axis=-1)
    acf = np.fft.irfft(spec * np.conj(spec), n=nfft, axis=-1)[:, :lag_max]
    taus = np.arange(lag_max)
    sq = frames * frames
    csum = np.concatenate([np.zeros_like(sq[:, :1]), np.cumsum(sq, axis=-1)], axis=-1)
    d = (csum[:, w - lag_max + 1: w + 1][:, ::-1] - 2.0 * acf
         + csum[:, w:] - csum[:, :lag_max])
    d = np.maximum(d, 0.0)
    cum = np.cumsum(d[:, 1:], axis=-1)
    dprime = np.concatenate([np.ones_like(d[:, :1]),
                             d[:, 1:] * taus[1:] / np.maximum(cum, 1e-7)], axis=-1)
    mmin, mmax = yingram_midi_range(sr, lag_min, lag_max)
    lags = midi_to_lag(sr, np.arange(mmin, mmax + 1, 1.0 / bins_per_semitone))
    lo = np.clip(np.floor(lags).astype(np.int64), 0, lag_max - 1)
    hi = np.clip(lo + 1, 0, lag_max - 1)
    frac = (lags - lo) / np.maximum(hi - lo, 1)
    img = (dprime[:, hi] - dprime[:, lo]) * frac + dprime[:, lo]
    return img.astype(np.float32)


def acf_f0_np(x: np.ndarray, sr: int, hop_length: int = 256, frame_length: int = 2048,
              f0_min: float = 80.0, f0_max: float = 880.0, voicing_threshold: float = 0.45,
              median_width: int = 3) -> np.ndarray:
    """Autocorrelation F0 (Hz, 0 where unvoiced), independent of YIN: each
    centred frame's normalised autocorrelation peak in the lags of
    [f0_min, f0_max], refined by a parabola through its neighbours, taken where
    it reaches ``voicing_threshold``; then a median over ``median_width`` frames
    where both the frame and the median are voiced. ``1 + len(x) // hop``
    frames, as ``yin_f0_np``."""
    n_frames = 1 + len(x) // hop_length
    pad = frame_length // 2
    xp = np.pad(x.astype(np.float64), (pad, pad + frame_length))
    lag_min = max(2, int(sr / f0_max))
    lag_max = min(int(sr / f0_min), frame_length - 1)
    f0 = np.zeros(n_frames)
    for i in range(n_frames):
        frame = xp[i * hop_length: i * hop_length + frame_length]
        frame = frame - frame.mean()
        e0 = np.sum(frame ** 2)
        if e0 < 1e-8:
            continue
        ac = np.correlate(frame, frame, mode="full")[frame_length - 1:] / (e0 + 1e-12)
        seg = ac[lag_min: lag_max + 1]
        k = int(np.argmax(seg))
        if seg[k] < voicing_threshold:
            continue
        lag = float(lag_min + k)
        if 0 < k < len(seg) - 1:
            a, b, c = seg[k - 1], seg[k], seg[k + 1]
            denom = a - 2 * b + c
            if abs(denom) > 1e-12:
                lag += 0.5 * (a - c) / denom
        f0[i] = sr / lag
    if median_width > 1:
        from scipy.signal import medfilt

        sm = medfilt(f0, kernel_size=median_width | 1)
        f0 = np.where((f0 > 0) & (sm > 0), sm, f0)
    return f0.astype(np.float32)
