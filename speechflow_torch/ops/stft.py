"""Batched STFT / ISTFT (counterpart of ``speechflow_tpu/ops/stft.py``).

Periodic Hann window, centered reflect padding, ``rfft`` over frames cut as a
strided view; the inverse is windowed overlap-add normalised by the
overlap-added squared window. Shapes follow the JAX package: (..., T) ->
(..., n_frames, n_fft//2 + 1) and back.

The transforms run in float32 (complex64): cuFFT has no bfloat16 transform of
this kind, so a bf16 input is cast before the FFT (a float64 input stays
float64). The ISTFT's normaliser
depends only on the frame count, so it is computed once per length and device
and cached.
"""

from __future__ import annotations

import functools
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["hann_window", "frame_signal", "stft", "magnitude", "overlap_add", "istft"]


@functools.lru_cache(maxsize=None)
def _hann_np(win_len: int) -> np.ndarray:
    n = np.arange(win_len)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_len)


def hann_window(win_len: int, dtype: torch.dtype = torch.float32,
                device: tp.Union[str, torch.device, None] = None) -> torch.Tensor:
    """Periodic (``fftbins=True``) Hann window, computed in float64 then cast."""
    return torch.as_tensor(_hann_np(win_len), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)  # cached: a normal tensor even when first built in inference
def _default_window(n_fft: int, win_length: int, device: str) -> torch.Tensor:
    return _window(n_fft, win_length, hann_window(win_length), device)


def _window(n_fft: int, win_length: tp.Optional[int], window: tp.Optional[torch.Tensor],
            device) -> torch.Tensor:
    """The analysis/synthesis window as float32 of length n_fft on ``device``."""
    win_length = win_length or n_fft
    if window is None:
        return _default_window(n_fft, win_length, str(device))
    if win_length < n_fft:  # center-pad the window to n_fft, librosa-style
        lp = (n_fft - win_length) // 2
        window = F.pad(window, (lp, n_fft - win_length - lp))
    return window.to(device=device, dtype=torch.float32)


def frame_signal(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_length), a strided view of ``x``."""
    return x.unfold(-1, frame_length, hop_length)


def _pad_center(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    pad = n_fft // 2
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    return xp.reshape(*lead, xp.shape[-1])


def stft(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
         win_length: tp.Optional[int] = None, window: tp.Optional[torch.Tensor] = None,
         center: bool = True) -> torch.Tensor:
    """Complex STFT of (..., T) -> (..., n_frames, n_fft//2 + 1), complex64
    (complex128 from float64)."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    w = _window(n_fft, win_length, window, x.device)
    if center:
        x = _pad_center(x, n_fft)
    return torch.fft.rfft(frame_signal(x, n_fft, hop_length) * w, n=n_fft, dim=-1)


def magnitude(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
              win_length: tp.Optional[int] = None, center: bool = True) -> torch.Tensor:
    """|STFT| as (..., n_frames, n_bins), float32 (float64 from float64)."""
    return stft(x, n_fft, hop_length, win_length, center=center).abs()


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(..., n_frames, F) -> (..., hop·(n_frames-1) + F).

    When hop divides F, the sum of R = F/hop shifted strip planes (each frame
    cut into hop-sized strips); otherwise a scatter-add over the flat index.
    """
    n_frames, f = frames.shape[-2], frames.shape[-1]
    lead = frames.shape[:-2]
    out_len = f + hop_length * (n_frames - 1)
    if f % hop_length == 0:
        r = f // hop_length
        strips = frames.reshape(*lead, n_frames, r, hop_length)
        acc = None
        for k in range(r):
            part = F.pad(strips[..., k, :], (0, 0, k, r - 1 - k))
            acc = part if acc is None else acc + part
        return acc.reshape(*lead, out_len)
    idx = (torch.arange(n_frames, device=frames.device)[:, None] * hop_length
           + torch.arange(f, device=frames.device)[None, :]).reshape(-1)
    flat = frames.reshape(-1, n_frames * f)
    out = flat.new_zeros(flat.shape[0], out_len).index_add_(1, idx, flat)
    return out.reshape(*lead, out_len)


def _window_sum(w: torch.Tensor, hop_length: int, n_frames: int) -> torch.Tensor:
    """max(overlap-added squared window, 1e-11) over the full OLA length."""
    wsum = overlap_add((w * w).expand(n_frames, w.shape[0]), hop_length)
    return torch.clamp(wsum, min=1e-11)


@functools.lru_cache(maxsize=64)
@torch.inference_mode(False)
def _default_window_sum(n_fft: int, win_length: int, hop_length: int, n_frames: int,
                        device: str) -> torch.Tensor:
    return _window_sum(_default_window(n_fft, win_length, device), hop_length, n_frames)


def istft(spec: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
          win_length: tp.Optional[int] = None, window: tp.Optional[torch.Tensor] = None,
          length: tp.Optional[int] = None) -> torch.Tensor:
    """Inverse of a centered STFT: complex (..., n_frames, n_fft//2 + 1) ->
    (..., (n_frames-1)·hop) float32 (``n_fft//2`` cropped on each side)."""
    w = _window(n_fft, win_length, window, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * w
    n_frames = frames.shape[-2]
    out_len = n_fft + hop_length * (n_frames - 1)
    if window is None:
        wsum = _default_window_sum(n_fft, win_length or n_fft, hop_length, n_frames,
                                   str(spec.device))
    else:
        wsum = _window_sum(w, hop_length, n_frames)
    sig = overlap_add(frames, hop_length) / wsum
    pad = n_fft // 2
    sig = sig[..., pad: out_len - pad]
    return sig if length is None else sig[..., :length]
