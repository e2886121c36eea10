"""Constant-Q transform, octave-recursive (counterpart of
``speechflow_tpu/ops/cqt.py``).

One complex kernel bank for the top octave (built in numpy, as the JAX
package builds it); each lower octave reuses it on the signal decimated by 2
(a 65-tap Kaiser half-band FIR, stride 2). The signal is first upsampled 2x
(zero-stuffing + the same FIR, gain 2). Per octave the analysis is frames ×
bank, one plain matrix product (the JAX package leaves it to XLA too). The
octaves are concatenated in ascending order; (real, imag) is the last axis.

The transform runs in float32 with autocast off: it is the discriminators'
front end, which the JAX package computes in the waveform's f32 under mixed
precision as well.
"""

from __future__ import annotations

import functools
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from speechflow_torch.ops.stft import frame_signal

__all__ = ["cqt", "cqt_frequencies", "naive_cqt_np"]


def cqt_frequencies(fmin: float, n_bins: int, bins_per_octave: int) -> np.ndarray:
    return fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)


@functools.lru_cache(maxsize=None)
def _top_octave_bank(sr: int, fmin: float, n_bins: int, bins_per_octave: int,
                     filter_scale: float = 1.0) -> tp.Tuple[np.ndarray, int]:
    """(bank, L): (L, 2·B) [real | imag] kernels of the B highest bins, L even."""
    freqs = cqt_frequencies(fmin, n_bins, bins_per_octave)[-bins_per_octave:]
    q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    lens = np.ceil(q * sr / freqs).astype(int)
    length = int(2 * np.ceil(lens.max() / 2))
    bank = np.zeros((length, 2 * bins_per_octave), np.float32)
    for k, (f, n) in enumerate(zip(freqs, lens)):
        n = int(n)
        start = (length - n) // 2
        t = (np.arange(n) - (n - 1) / 2) / sr
        kern = np.hanning(n) * np.exp(2j * np.pi * f * t) / n
        bank[start:start + n, k] = kern.real
        bank[start:start + n, bins_per_octave + k] = kern.imag
    return bank, length


@functools.lru_cache(maxsize=None)
def _halfband_fir(taps: int = 65, beta: float = 8.0) -> np.ndarray:
    """Kaiser-windowed sinc low-pass at half band."""
    n = np.arange(taps) - (taps - 1) / 2
    h = np.sinc(n / 2.0) / 2.0
    h *= np.kaiser(taps, beta)
    return (h / h.sum() * 1.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)  # cached: a normal tensor even when first built in inference
def _on(key: tuple, device: str) -> torch.Tensor:
    kind, *args = key
    arr = _top_octave_bank(*args)[0] if kind == "bank" else _halfband_fir() * args[0]
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)


def _fir_1d(x: torch.Tensor, h: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """(B, T) 'same' FIR (correlation, pad (K-1)//2 before) with optional decimation."""
    taps = h.shape[0]
    pad = (taps - 1) // 2
    xp = F.pad(x[:, None], (pad, taps - 1 - pad))
    return F.conv1d(xp, h[None, None], stride=stride)[:, 0]


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """2x interpolation: zero-stuff + half-band FIR (gain-compensated)."""
    b, t = x.shape
    up = torch.stack([x, torch.zeros_like(x)], dim=-1).reshape(b, 2 * t)
    return _fir_1d(up, _on(("fir", 2.0), str(x.device)).to(x.dtype))


def cqt(wav: torch.Tensor, sr: int, hop_length: int = 256, fmin: float = 32.703195,
        n_octaves: int = 9, bins_per_octave: int = 24, filter_scale: float = 1.0,
        upsample: bool = True) -> torch.Tensor:
    """(B, T) waveform -> (B, n_frames, n_octaves·bins_per_octave, 2) float32 CQT
    (float64 for a float64 waveform).

    ``hop_length`` is in samples at the working rate (twice ``sr`` with
    ``upsample``) and must be divisible by 2**(n_octaves-1); the top bin must
    lie below the working Nyquist. Either violation raises ``ValueError``."""
    if wav.ndim == 1:
        wav = wav[None]
    work_sr = sr * 2 if upsample else sr
    if hop_length % (2 ** (n_octaves - 1)) != 0:
        raise ValueError(f"hop_length {hop_length} must be divisible by 2^{n_octaves - 1}")
    n_bins = n_octaves * bins_per_octave
    nyq = work_sr / 2
    top = cqt_frequencies(fmin, n_bins, bins_per_octave)[-1]
    if top >= nyq:
        raise ValueError(f"top CQT bin {top:.0f} Hz >= nyquist {nyq:.0f} Hz")
    dev = str(wav.device)
    with torch.autocast(device_type=wav.device.type, enabled=False):
        x = wav if wav.dtype == torch.float64 else wav.float()
        x = _upsample2(x) if upsample else x
        length = _top_octave_bank(work_sr, fmin, n_bins, bins_per_octave, filter_scale)[1]
        bank = _on(("bank", work_sr, fmin, n_bins, bins_per_octave, filter_scale), dev).to(x.dtype)
        fir = _on(("fir", 1.0), dev).to(x.dtype)
        octaves: tp.List[torch.Tensor] = []
        hop = hop_length
        n_frames = x.shape[-1] // hop_length + 1
        for o in range(n_octaves):
            xp = F.pad(x, (length // 2, length // 2))
            z = torch.matmul(frame_signal(xp, length, hop), bank)[:, :n_frames]
            if z.shape[1] < n_frames:
                z = F.pad(z, (0, 0, 0, n_frames - z.shape[1]))
            re, im = z.chunk(2, dim=-1)
            octaves.append(torch.stack([re, im], dim=-1))
            if o < n_octaves - 1:
                x = _fir_1d(x, fir, stride=2)
                hop //= 2
        # octaves[0] is the top octave; the output ascends from fmin
        return torch.cat(octaves[::-1], dim=2)


def naive_cqt_np(wav: np.ndarray, sr: int, hop_length: int,
                 fmin: float = 32.703195, n_octaves: int = 9,
                 bins_per_octave: int = 24, filter_scale: float = 1.0,
                 upsample: bool = True) -> np.ndarray:
    """The CQT by its definition, in float64 on the host: a Hann-windowed
    complex kernel of ``ceil(q·sr/f)`` samples per bin, centred on every
    ``hop_length``-th sample (zeros outside the signal), after the same
    half-band 2x upsampling as ``cqt``. O(frames · bins · kernel length): the
    oracle ``cqt`` is held to. Returns (frames, bins) complex128."""
    if upsample:
        up = np.zeros(2 * len(wav), np.float64)
        up[::2] = wav
        h = _halfband_fir().astype(np.float64) * 2.0
        pad = (len(h) - 1) // 2
        wav = np.convolve(up, h)[pad:pad + len(up)]
        sr = sr * 2
    n_bins = n_octaves * bins_per_octave
    freqs = cqt_frequencies(fmin, n_bins, bins_per_octave)
    q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    n_frames = len(wav) // hop_length + 1
    out = np.zeros((n_frames, n_bins), np.complex128)
    for j, f in enumerate(freqs):
        n = int(np.ceil(q * sr / f))
        t = (np.arange(n) - (n - 1) / 2) / sr
        kern = np.hanning(n) * np.exp(2j * np.pi * f * t) / n
        for fr in range(n_frames):
            a = fr * hop_length - n // 2
            seg = np.zeros(n)
            lo, hi = max(a, 0), min(a + n, len(wav))
            if hi > lo:
                seg[lo - a:hi - a] = wav[lo:hi]
            out[fr, j] = (seg * kern).sum()
    return out
