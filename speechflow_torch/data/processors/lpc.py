"""LPC features (counterpart of ``speechflow_tpu/data/processors/lpc.py``):
per-frame linear-prediction coefficients by the autocorrelation method
(Levinson-Durbin), from the waveform (Hann frames, centred by reflection) or
from a magnitude spectrogram (the inverse FFT of its power), and the per-frame
RMS of the prediction residual. Host numpy.
"""

from __future__ import annotations

import numpy as np

from speechflow_torch.data.core.datasample import SpectrogramDataSample
from speechflow_torch.data.processors import handler
from speechflow_torch.data.processors.np_dsp import _frame_np, hann_window_np

__all__ = ["levinson_durbin", "lpc_from_signal", "lpc_from_magnitude", "lpc",
           "lpc_from_spectrogram", "lpc_decompose"]


def levinson_durbin(r: np.ndarray, order: int) -> np.ndarray:
    """Autocorrelations (..., order + 1) -> LPC coefficients (N, order),
    float32; the prediction error is floored at 1e-9."""
    r = np.atleast_2d(r)
    a = np.zeros((r.shape[0], order + 1), np.float64)
    a[:, 0] = 1.0
    err = np.maximum(r[:, 0].copy(), 1e-9)
    for i in range(1, order + 1):
        acc = r[:, i].copy()
        for j in range(1, i):
            acc += a[:, j] * r[:, i - j]
        k = -acc / err
        a_new = a.copy()
        for j in range(1, i):
            a_new[:, j] = a[:, j] + k * a[:, i - j]
        a_new[:, i] = k
        a = a_new
        err = np.maximum(err * (1.0 - k * k), 1e-9)
    return a[:, 1:].astype(np.float32)


def lpc_from_signal(wav: np.ndarray, order: int = 16, frame_length: int = 1024,
                    hop: int = 256) -> np.ndarray:
    pad = frame_length // 2
    xp = np.pad(wav.astype(np.float64), (pad, pad), mode="reflect")
    frames = _frame_np(xp, frame_length, hop) * hann_window_np(frame_length)
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    r = np.fft.irfft(spec, axis=-1)[:, :order + 1]
    return levinson_durbin(r, order)


def lpc_from_magnitude(mag: np.ndarray, order: int = 16) -> np.ndarray:
    """(T, n_bins) magnitude -> (T, order) LPC through the spectral
    autocorrelation."""
    r = np.fft.irfft(mag.astype(np.float64) ** 2, axis=-1)[:, :order + 1]
    return levinson_durbin(r, order)


@handler(inputs={"audio_chunk"}, outputs={"lpc_feat"})
def lpc(ds: SpectrogramDataSample, order: int = 16,
        frame_length: int = 1024) -> SpectrogramDataSample:
    """``additional["lpc_feat"]``: (T, order), cut to the magnitude's frames."""
    hop = ds.get_param_val("hop_len", ds.hop_len or 256)
    feats = lpc_from_signal(ds.audio_chunk.waveform, order, frame_length, hop)
    if ds.magnitude is not None:
        feats = feats[:ds.magnitude.shape[0]]
    ds.additional["lpc_feat"] = feats
    return ds


@handler(inputs={"magnitude"}, outputs={"lpc_feat"})
def lpc_from_spectrogram(ds: SpectrogramDataSample, order: int = 16) -> SpectrogramDataSample:
    ds.additional["lpc_feat"] = lpc_from_magnitude(ds.magnitude, order)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"lpc_residual"})
def lpc_decompose(ds: SpectrogramDataSample, order: int = 16,
                  frame_length: int = 1024) -> SpectrogramDataSample:
    """``additional["lpc_residual"]``: per frame, the RMS of the frame minus its
    LPC prediction (unwindowed frames)."""
    hop = ds.get_param_val("hop_len", ds.hop_len or 256)
    wav = ds.audio_chunk.waveform.astype(np.float64)
    coefs = lpc_from_signal(wav, order, frame_length, hop)
    pad = frame_length // 2
    frames = _frame_np(np.pad(wav, (pad, pad), mode="reflect"), frame_length, hop)
    resid = np.zeros(len(coefs), np.float32)
    for t in range(len(coefs)):
        fr = frames[t]
        pred = np.zeros_like(fr)
        for j in range(order):
            pred[j + 1:] -= coefs[t, j] * fr[:len(fr) - j - 1]
        resid[t] = float(np.sqrt(np.mean((fr - pred) ** 2) + 1e-12))
    ds.additional["lpc_residual"] = resid
    return ds
