"""Batched YIN F0 (counterpart of ``yin_f0`` in ``speechflow_tpu/ops/pitch.py``,
the one function of that module the vocoder's validation metrics use).

The difference function comes from FFT correlations of centered,
reflect-padded frames (1 + T // hop of them, as a centered STFT gives); the
CMNDF's first local minimum under the threshold (else its global minimum) is
refined by a parabola; frames whose CMNDF minimum or energy is too high, or
whose F0 leaves [f0_min, f0_max], are unvoiced (0).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from speechflow_torch.ops.stft import frame_signal

__all__ = ["yin_f0"]


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
