"""PESQ (ITU-T P.862 / P.862.2 wideband) — offline, numpy (a copy of
``speechflow_tpu/models/vocoder/pesq.py``: the port imports nothing of the JAX
package, so it keeps its own; the parity tests hold the two equal).

The reference validates vocoder runs with wideband PESQ at 16 kHz
(tts/vocoders/vocos/lightning_engine.py:69,468: ``pesq(16000, ref, deg,
"wb")``). That relies on the compiled ``pesq`` wheel; this module implements
the P.862 perceptual model from the specification so validation runs offline:

  1. resample both signals to 16 kHz, wideband input filter (100 Hz IIR
     high-pass — P.862.2 replaces the narrowband IRS receive filter),
  2. level alignment of each signal to the standard active power in the
     350–3250 Hz band,
  3. envelope + fine cross-correlation time alignment (global delay),
  4. 32 ms Hann frames, 50 % overlap -> pitch power densities on a 49-band
     Bark-warped axis,
  5. partial frequency compensation of the reference (per-band, clipped to
     +-20 dB) and short-term gain compensation of the degraded signal,
  6. Zwicker loudness transform with a hearing-threshold floor,
  7. masked disturbance and asymmetric disturbance densities,
  8. L2-over-bands, L6-over-syllables (20 frames), L2-over-time aggregation
     with the (power+1e5)^0.04 frame normalization and the 45 cap,
  9. raw score 4.5 - 0.1*D - 0.0309*DA, mapped through the P.862.2 logistic
     to wideband MOS-LQO.

Deviations from the ITU reference C implementation (documented for honesty,
see docs/standins.md): a single global time alignment (no per-utterance
re-splitting on bad intervals), Bark band edges generated from the analytic
Zwicker formula instead of the ITU table, and a fitted loudness calibration
constant. The score is therefore PESQ-class, not bit-exact P.862; it is
pinned by tests to be perfect-on-identical, strictly monotone in SNR and
distortion, and properly ranked across distortion types.
"""

from __future__ import annotations

import typing as tp

import numpy as np

__all__ = ["pesq_wb", "pesq_raw"]

_SR = 16000
_FRAME = 512            # 32 ms at 16 kHz
_HOP = 256
_N_BARK = 49
_TARGET_POWER = 1e7     # standard active level after alignment


def _bark(f: np.ndarray) -> np.ndarray:
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _hearing_threshold_power(fc: np.ndarray) -> np.ndarray:
    """Absolute hearing threshold per band center (Terhardt), converted from
    dB SPL to the internal power scale via the level calibration below."""
    khz = np.maximum(fc, 20.0) / 1000.0
    spl = (3.64 * khz ** -0.8
           - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
           + 1e-3 * khz ** 4)
    # calibration: a 0 dB SPL tone maps to power ~1e3 on the internal scale,
    # putting speech at the standard active level ~30-60 dB above threshold
    # (fitted; at high sensation levels the Zwicker law is threshold-
    # independent, so this constant mostly controls near-threshold behavior)
    return 1e3 * 10.0 ** (spl / 10.0)


def _band_matrix(sr: int = _SR, n_fft: int = _FRAME,
                 n_bands: int = _N_BARK) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(bands x bins) averaging matrix over equal-Bark intervals + band
    centers (Hz) + band widths (Bark)."""
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    z = _bark(freqs)
    edges = np.linspace(0.0, _bark(np.asarray([sr / 2.0]))[0], n_bands + 1)
    mat = np.zeros((n_bands, len(freqs)))
    for b in range(n_bands):
        sel = (z >= edges[b]) & (z < edges[b + 1])
        if not sel.any():  # empty low band: take the nearest bin
            sel = np.zeros_like(sel)
            sel[np.argmin(np.abs(z - 0.5 * (edges[b] + edges[b + 1])))] = True
        mat[b, sel] = 1.0  # pitch power density SUMS bin powers per band
    centers = (mat / mat.sum(1, keepdims=True)) @ freqs
    widths = np.diff(edges)
    return mat, centers, widths


def _highpass_100(x: np.ndarray, sr: int) -> np.ndarray:
    from scipy.signal import butter, sosfilt

    sos = butter(2, 100.0, btype="highpass", fs=sr, output="sos")
    return sosfilt(sos, x)


def _level_align(x: np.ndarray, sr: int) -> np.ndarray:
    """Scale to the standard active power measured in 350-3250 Hz."""
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / sr)
    band = (freqs >= 350.0) & (freqs <= 3250.0)
    # mean-square per sample restricted to the band (Parseval)
    msq = (np.abs(spec[band]) ** 2).sum() / max(len(x), 1) ** 2 * 2.0
    # active-speech correction: mean power over speech-active 10 ms frames
    frame_e = x[: len(x) // 160 * 160].reshape(-1, 160)
    active = (frame_e ** 2).mean(1) > 1e-4 * max((frame_e ** 2).mean(1).max(), 1e-12)
    activity = max(active.mean(), 0.05)
    scale = np.sqrt(_TARGET_POWER * activity / max(msq, 1e-12))
    return x * scale


def _time_align(ref: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """Shift `deg` onto `ref`: coarse envelope xcorr + fine waveform xcorr."""
    hop = 160
    n = min(len(ref), len(deg)) // hop
    env_r = np.sqrt((ref[: n * hop].reshape(n, hop) ** 2).mean(1) + 1e-12)
    env_d = np.sqrt((deg[: n * hop].reshape(n, hop) ** 2).mean(1) + 1e-12)
    xc = np.correlate(env_d - env_d.mean(), env_r - env_r.mean(), mode="full")
    coarse = (np.argmax(xc) - (n - 1)) * hop
    # fine: +-hop around the coarse delay on the waveforms
    best, best_v = 0, -np.inf
    for d in range(-hop, hop + 1, 4):
        delay = coarse + d
        if delay >= 0:
            a, b = ref[: len(deg) - delay], deg[delay:]
        else:
            a, b = ref[-delay:], deg[: len(ref) + delay]
        m = min(len(a), len(b))
        if m < _FRAME:
            continue
        v = float(np.dot(a[:m], b[:m]))
        if v > best_v:
            best_v, best = v, delay
    if best >= 0:
        return deg[best:]
    return np.concatenate([np.zeros(-best, deg.dtype), deg])


def _pitch_power_density(x: np.ndarray, mat: np.ndarray) -> np.ndarray:
    n = (len(x) - _FRAME) // _HOP + 1
    if n < 1:
        return np.zeros((0, mat.shape[0]))
    idx = np.arange(_FRAME)[None, :] + _HOP * np.arange(n)[:, None]
    frames = x[idx] * np.hanning(_FRAME)
    power = np.abs(np.fft.rfft(frames, axis=1)) ** 2 / _FRAME
    return power @ mat.T


def _loudness(pp: np.ndarray, thr: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Zwicker loudness density per band (P.862 Sl-scaled power law)."""
    sl = 0.23
    ratio = pp / thr[None, :]
    loud = ((thr[None, :] / 0.5) ** sl) * ((0.5 + 0.5 * ratio) ** sl - 1.0)
    return np.where(ratio > 1e-2, loud, 0.0) * widths[None, :]


def pesq_raw(ref: np.ndarray, deg: np.ndarray, sr: int) -> float:
    """Raw P.862 score (~ -0.5 .. 4.5) for ref vs degraded audio."""
    from scipy.signal import resample_poly

    ref = np.asarray(ref, np.float64).ravel()
    deg = np.asarray(deg, np.float64).ravel()
    if sr != _SR:
        g = np.gcd(int(sr), _SR)
        ref = resample_poly(ref, _SR // g, sr // g)
        deg = resample_poly(deg, _SR // g, sr // g)
    ref = _level_align(_highpass_100(ref, _SR), _SR)
    deg = _level_align(_highpass_100(deg, _SR), _SR)
    deg = _time_align(ref, deg)
    t = min(len(ref), len(deg))
    ref, deg = ref[:t], deg[:t]

    mat, centers, widths = _band_matrix()
    thr = _hearing_threshold_power(centers)
    pp_r = _pitch_power_density(ref, mat)
    pp_d = _pitch_power_density(deg, mat)
    n = min(len(pp_r), len(pp_d))
    if n == 0:
        return 4.5
    pp_r, pp_d = pp_r[:n], pp_d[:n]

    # speech-active frames of the reference drive the compensations
    frame_pow = pp_r.sum(1)
    active = frame_pow > 1e-2 * max(frame_pow.max(), 1e-12)
    if not active.any():
        active = np.ones(n, bool)

    # partial frequency compensation: correct the REFERENCE for linear
    # filtering in the degraded chain (per band, clipped +-20 dB)
    num = (pp_d[active] + 1000.0).mean(0)
    den = (pp_r[active] + 1000.0).mean(0)
    bf = np.clip(num / den, 10.0 ** -2.0, 10.0 ** 2.0)
    # compensate spectral SHAPE only: overall gain differences belong to the
    # short-term gain compensation below, and letting a silent/attenuated
    # degraded signal shrink the whole reference would hide total signal loss
    bf /= np.exp(np.mean(np.log(bf)))
    pp_r_c = pp_r * bf[None, :]

    # short-term gain compensation of the DEGRADED signal (frame ratio,
    # first-order smoothed, clipped)
    ratio = (pp_r_c.sum(1) + 5e5) / (pp_d.sum(1) + 5e5)
    smoothed = np.empty_like(ratio)
    g = 1.0
    for i in range(n):
        g = 0.8 * g + 0.2 * ratio[i]
        smoothed[i] = np.clip(g, 3e-4, 5.0)
    pp_d_c = pp_d * smoothed[:, None]

    l_r = _loudness(pp_r_c, thr, widths)
    l_d = _loudness(pp_d_c, thr, widths)

    d = l_d - l_r
    mask = 0.25 * np.minimum(l_d, l_r)
    disturb = np.sign(d) * np.maximum(np.abs(d) - mask, 0.0)

    # asymmetry factor per (frame, band)
    asym = ((pp_d_c + 50.0) / (pp_r_c + 50.0)) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))

    # frame disturbances: width-weighted L2 for symmetric, L1 for asymmetric
    d_frame = np.sqrt((disturb ** 2 * widths[None, :]).sum(1))
    da_frame = (np.abs(disturb) * asym * widths[None, :]).sum(1)

    # frame normalization by audible reference power, cap at 45
    norm = ((pp_r_c.sum(1) + 1e5) / 1e7) ** 0.04
    d_frame = np.minimum(d_frame / norm, 45.0)
    da_frame = np.minimum(da_frame / norm, 45.0)

    def _aggregate(vals: np.ndarray) -> float:
        # L6 over 20-frame syllables (50% overlap), then L2 over syllables
        if len(vals) < 20:
            chunks = [vals]
        else:
            chunks = [vals[i:i + 20] for i in range(0, len(vals) - 19, 10)]
        l6 = np.asarray([np.mean(c ** 6.0) ** (1.0 / 6.0) for c in chunks])
        return float(np.sqrt(np.mean(l6 ** 2)))

    d_sym = _aggregate(d_frame)
    d_asym = _aggregate(da_frame)
    return float(4.5 - 0.1 * d_sym - 0.0309 * d_asym)


def pesq_wb(ref: np.ndarray, deg: np.ndarray, sr: int = 16000) -> float:
    """Wideband MOS-LQO via the P.862.2 output mapping (1.0 .. ~4.64)."""
    raw = pesq_raw(ref, deg, sr)
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224)))
