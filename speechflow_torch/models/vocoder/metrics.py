"""Vocoder validation metrics (counterpart of
``speechflow_tpu/models/vocoder/metrics.py``): voicing F1, pitch and
periodicity errors from the batched YIN (``ops.pitch.yin_f0``), mel-cepstral
distortion, scale-invariant SNR, and the ``MOSHook`` slot for an external MOS
predictor. Numpy in, floats out; the DSP runs on the CPU."""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from speechflow_torch.ops.mel import amp_to_db, linear_to_mel
from speechflow_torch.ops.pitch import yin_f0
from speechflow_torch.ops.stft import magnitude

__all__ = ["periodicity_metrics", "mel_cepstral_distortion", "si_snr", "MOSHook"]


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def periodicity_metrics(fake: np.ndarray, real: np.ndarray, sr: int = 24000,
                        hop: int = 256) -> tp.Dict[str, float]:
    """Voiced/unvoiced F1, pitch RMSE over frames voiced in both, and the RMSE
    of the voiced fractions per utterance."""
    f0_f = yin_f0(_t(fake), sr, hop).numpy()
    f0_r = yin_f0(_t(real), sr, hop).numpy()
    v_f, v_r = f0_f > 0, f0_r > 0
    tp_ = np.sum(v_f & v_r)
    precision = tp_ / max(v_f.sum(), 1)
    recall = tp_ / max(v_r.sum(), 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    both = v_f & v_r
    pitch_rmse = float(np.sqrt(np.mean((f0_f[both] - f0_r[both]) ** 2))) if both.any() else 0.0
    per_err = float(np.sqrt(np.mean((v_f.mean(-1) - v_r.mean(-1)) ** 2)))
    return {"voicing_f1": float(f1), "pitch_rmse_hz": pitch_rmse,
            "periodicity_rmse": per_err}


def mel_cepstral_distortion(fake: np.ndarray, real: np.ndarray, sr: int = 24000,
                            n_fft: int = 1024, hop: int = 256, n_mels: int = 80,
                            n_ceps: int = 13) -> float:
    """MCD in dB over aligned frames (10·√2/ln 10 scaling)."""
    from scipy.fftpack import dct

    def ceps(w):
        logmel = amp_to_db(linear_to_mel(magnitude(_t(w), n_fft, hop), sr, n_mels)).numpy()
        return dct(logmel, axis=-1, norm="ortho")[..., 1:n_ceps]

    c_f, c_r = ceps(fake), ceps(real)
    t = min(c_f.shape[1], c_r.shape[1])
    diff = c_f[:, :t] - c_r[:, :t]
    return float(10.0 * np.sqrt(2.0) / np.log(10.0) * np.mean(np.sqrt(np.sum(diff**2, -1))))


def si_snr(fake: np.ndarray, real: np.ndarray) -> float:
    """Scale-invariant SNR in dB."""
    t = min(fake.shape[-1], real.shape[-1])
    f, r = fake[..., :t], real[..., :t]
    f = f - f.mean(-1, keepdims=True)
    r = r - r.mean(-1, keepdims=True)
    proj = (np.sum(f * r, -1, keepdims=True)
            / np.maximum(np.sum(r * r, -1, keepdims=True), 1e-9)) * r
    noise = f - proj
    ratio = np.sum(proj**2, -1) / np.maximum(np.sum(noise**2, -1), 1e-9)
    return float(np.mean(10 * np.log10(np.maximum(ratio, 1e-9))))


class MOSHook:
    """Inject an external MOS predictor (UTMOS-class). Default: None scores."""

    def __call__(self, wav: np.ndarray, sr: int) -> tp.Optional[float]:
        return None
