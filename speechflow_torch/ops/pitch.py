"""Batched F0 and pitch images (counterpart of ``speechflow_tpu/ops/pitch.py``):
YIN F0 (``yin_f0``) and the NANSY-style yingram (``yingram``), with the midi
<-> lag conversions of its grid.

The difference function comes from FFT correlations of centered,
reflect-padded frames (1 + T // hop of them, as a centered STFT gives); the
CMNDF's first local minimum under the threshold (else its global minimum) is
refined by a parabola; frames whose CMNDF minimum or energy is too high, or
whose F0 leaves [f0_min, f0_max], are unvoiced (0). ``yingram`` samples the lag-normalised CMNDF of the same
centred frames on a grid of ``bins_per_semitone`` bins per midi semitone over
[lag_min, lag_max] by linear interpolation (the correlation zero-padded, so
linear, not circular).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from speechflow_torch.ops.stft import frame_signal

__all__ = ["yin_f0", "yingram", "yingram_midi_range", "midi_to_lag", "lag_to_midi"]


def midi_to_lag(sr: float, midi) -> np.ndarray:
    """Midi note -> time lag in samples (A4 = 69 at 440 Hz)."""
    return sr / (440.0 * 2.0 ** ((np.asarray(midi, np.float64) - 69.0) / 12.0))


def lag_to_midi(sr: float, lag) -> np.ndarray:
    """Time lag in samples -> midi note."""
    return 12.0 * np.log2(sr / (440.0 * np.asarray(lag, np.float64))) + 69.0


def yingram_midi_range(sr: int, lag_min: int, lag_max: int) -> tp.Tuple[int, int]:
    """Closed midi interval covered by the lag search range."""
    return int(np.ceil(lag_to_midi(sr, lag_max))), int(lag_to_midi(sr, lag_min))


def yingram(x: torch.Tensor, sr: int, hop_length: int = 256, frame_length: int = 2048,
            lag_min: int = 22, lag_max: int = 2047, bins_per_semitone: int = 20
            ) -> torch.Tensor:
    """(B, T) or (T,) waveform -> (B, 1 + T // hop, n_bins) midi-scale CMNDF
    image, float32 (low values mark periodicity at a bin's pitch)."""
    squeeze = x.ndim == 1
    x = (x[None] if squeeze else x).float()
    w = frame_length
    if lag_max >= w:
        raise ValueError("frame_length must exceed lag_max")
    pad = w // 2
    frames = frame_signal(F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0], w, hop_length)
    nfft = int(2 ** np.ceil(np.log2(w + lag_max)))
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)
    acf = torch.fft.irfft(spec * torch.conj(spec), n=nfft, dim=-1)[..., :lag_max]
    sq = frames * frames
    csum = F.pad(torch.cumsum(sq, dim=-1), (1, 0))
    taus = torch.arange(lag_max, device=x.device)
    # d(tau) = c[W-tau] - 2 acf(tau) + c[W] - c[tau], c = cumsum(x^2)
    d = (csum[..., w - lag_max + 1: w + 1].flip(-1) - 2.0 * acf
         + csum[..., w:] - csum[..., :lag_max])
    d = torch.clamp(d, min=0.0)
    cum = torch.cumsum(d[..., 1:], dim=-1)
    dprime = torch.cat([torch.ones_like(d[..., :1]),
                        d[..., 1:] * taus[1:] / torch.clamp(cum, min=1e-7)], dim=-1)
    mmin, mmax = yingram_midi_range(sr, lag_min, lag_max)
    lags = midi_to_lag(sr, np.arange(mmin, mmax + 1, 1.0 / bins_per_semitone))
    lo = np.clip(np.floor(lags).astype(np.int64), 0, lag_max - 1)
    hi = np.clip(lo + 1, 0, lag_max - 1)
    frac = torch.as_tensor((lags - lo) / np.maximum(hi - lo, 1), dtype=torch.float32,
                           device=x.device)
    lo, hi = (torch.as_tensor(a, device=x.device) for a in (lo, hi))
    img = (dprime[..., hi] - dprime[..., lo]) * frac + dprime[..., lo]
    return img[0] if squeeze else img


def yin_f0(x: torch.Tensor, sr: int, hop_length: int = 256, frame_length: int = 2048,
           f0_min: float = 80.0, f0_max: float = 880.0, threshold: float = 0.2
           ) -> torch.Tensor:
    """(B, T) waveform -> (B, n_frames) f0 in Hz (0 where unvoiced), float32."""
    squeeze = x.ndim == 1
    x = (x[None] if squeeze else x).float()
    tau_min = max(2, int(np.floor(sr / f0_max)))
    tau_max = int(np.ceil(sr / f0_min))
    w = frame_length
    if tau_max >= w:
        raise ValueError("frame_length must exceed sr/f0_min")
    pad = w // 2
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = frame_signal(xp, w, hop_length)  # (B, F, W)
    half = w // 2
    nfft = int(2 ** np.ceil(np.log2(w + tau_max)))

    sq = frames * frames
    csum = F.pad(torch.cumsum(sq, dim=-1), (1, 0))
    taus = torch.arange(tau_max + 1, device=x.device)
    e_tau = csum[..., taus + half] - csum[..., taus]
    e0 = e_tau[..., :1]
    spec_h = torch.fft.rfft(frames[..., :half], n=nfft, dim=-1)
    cross = torch.fft.irfft(torch.conj(spec_h) * torch.fft.rfft(frames, n=nfft, dim=-1),
                            n=nfft, dim=-1)
    d = torch.clamp(e0 + e_tau - 2.0 * cross[..., :tau_max + 1], min=0.0)

    cum = torch.cumsum(d[..., 1:], dim=-1)
    dprime = d[..., 1:] * taus[1:] / torch.clamp(cum, min=1e-12)
    dprime = torch.cat([torch.ones_like(d[..., :1]), dprime], dim=-1)

    lag_ok = (taus >= tau_min) & (taus <= tau_max)
    dp = torch.where(lag_ok, dprime, torch.full_like(dprime, float("inf")))
    inf = torch.full_like(dp[..., :1], float("inf"))
    left = torch.cat([inf, dp[..., :-1]], dim=-1)
    right = torch.cat([dp[..., 1:], inf], dim=-1)
    cand = (dp <= left) & (dp <= right) & (dp < threshold)
    tau_star = torch.where(cand.any(-1), cand.to(torch.uint8).argmax(-1), dp.argmin(-1))

    idx = torch.stack([torch.clamp(tau_star - 1, 0, tau_max), tau_star,
                       torch.clamp(tau_star + 1, 0, tau_max)], dim=-1)
    y = torch.gather(dprime, -1, idx)
    denom = y[..., 0] - 2.0 * y[..., 1] + y[..., 2]
    big = denom.abs() > 1e-12
    delta = torch.where(big, 0.5 * (y[..., 0] - y[..., 2]) / torch.where(big, denom, 1.0),
                        torch.zeros_like(denom))
    tau_refined = tau_star.float() + torch.clamp(delta, -0.5, 0.5)
    f0 = sr / torch.clamp(tau_refined, min=1.0)

    dp_min = torch.gather(dp, -1, tau_star[..., None])[..., 0]
    frame_rms = torch.sqrt(torch.mean(frames * frames, dim=-1))
    voiced = (dp_min < max(threshold, 0.35)) & (frame_rms > 1e-4)
    f0 = torch.where(voiced, f0, torch.zeros_like(f0))
    f0 = torch.where((f0 >= f0_min) & (f0 <= f0_max), f0, torch.zeros_like(f0))
    return f0[0] if squeeze else f0
