"""A trainable MOS proxy: a quality predictor without labels, for vocoder
validation (counterpart of ``speechflow_tpu/models/vocoder/mos_proxy.py``).

Clean corpus audio gets the top score and degraded copies (additive noise,
clipping, lowpass, coarse quantization) a score that falls with the
degradation's strength (``degrade``, numpy, the same draws as the JAX
package's under the same ``np.random.Generator``). A small strided-conv net
over log-mel regresses the score (``MOSProxy``); ``train_mos_proxy`` fits it
with Adam; ``MOSProxyHook`` is the ``(wav, sr) -> score`` callable that
``GANTrainer(mos_hook=...)`` reads in validation. A relative quality signal,
not a calibrated MOS.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from speechflow_torch.models.layers import Conv1d, flax_init_, layer_norm
from speechflow_torch.ops.mel import amp_to_db, linear_to_mel
from speechflow_torch.ops.stft import magnitude
from speechflow_torch.training.base_model import BaseModelParams
from speechflow_torch.utils.device import resolve_device

__all__ = ["MOSProxyParams", "MOSProxy", "degrade", "train_mos_proxy", "MOSProxyHook"]


@dataclasses.dataclass
class MOSProxyParams(BaseModelParams):
    sample_rate: int = 24000
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 64
    dim: int = 64
    n_layers: int = 3


class MOSProxy(nn.Module):
    """(B, N) waveform -> (B,) score in [1, 5]: log-mel, ``n_layers`` x (conv k5
    stride 2 -> ReLU -> LayerNorm), the mean over time, a linear, 1 + 4·sigmoid."""

    def __init__(self, params: MOSProxyParams):
        super().__init__()
        p = self.p = params
        dims = [p.n_mels] + [p.dim] * p.n_layers
        self.convs = nn.ModuleList(Conv1d(dims[i], dims[i + 1], 5, stride=2)
                                   for i in range(p.n_layers))
        self.norms = nn.ModuleList(layer_norm(p.dim) for _ in range(p.n_layers))
        self.head = nn.Linear(p.dim, 1)
        flax_init_(self)

    def _mel(self, wav: torch.Tensor) -> torch.Tensor:
        mag = magnitude(wav.float(), self.p.n_fft, self.p.hop_length)
        return amp_to_db(linear_to_mel(mag, self.p.sample_rate, self.p.n_mels))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self._mel(wav)
        for conv, norm in zip(self.convs, self.norms):
            x = norm(torch.relu(conv(x)))
        return 1.0 + 4.0 * torch.sigmoid(self.head(x.mean(dim=1))[..., 0])


def degrade(wav: np.ndarray, sr: int, level: float, rng,
            kind: tp.Optional[int] = None) -> np.ndarray:
    """``wav`` degraded at ``level`` in [0, 1] (0: clean). ``kind``: 0 additive
    noise (SNR 30 -> 0 dB), 1 clipping, 2 lowpass (Nyquist -> 1 kHz), 3
    quantization (12 -> 3 bits); None draws one from ``rng``."""
    from scipy.signal import butter, sosfiltfilt

    kind = rng.integers(0, 4) if kind is None else kind
    out = wav.astype(np.float64)
    if level <= 1e-6:
        return wav.astype(np.float32)
    if kind == 0:
        snr = 30.0 * (1.0 - level)
        noise = rng.standard_normal(len(out))
        scale = np.sqrt((np.mean(out**2) + 1e-12) / (np.mean(noise**2) * 10 ** (snr / 10)))
        out = out + scale * noise
    elif kind == 1:
        thr = np.quantile(np.abs(out), 1.0 - 0.4 * level) + 1e-9
        out = np.clip(out, -thr, thr)
    elif kind == 2:
        cutoff = sr / 2 * (1.0 - 0.9 * level) + 100
        sos = butter(6, min(cutoff, sr / 2 - 100), btype="low", fs=sr, output="sos")
        out = sosfiltfilt(sos, out)
    else:
        bits = 12 - 9 * level
        q = 2.0 ** (bits - 1)
        out = np.round(out * q) / q
    return out.astype(np.float32)


def mos_batch(waves: tp.Sequence[np.ndarray], sr: int, batch: int, n: int,
              rng: np.random.Generator) -> tp.Tuple[np.ndarray, np.ndarray]:
    """One training batch: ``batch`` random ``n``-sample chunks, each degraded at
    a random level (0 with probability 0.3), and their targets 5 - 4·level."""
    xs, ys = [], []
    for _ in range(batch):
        w = waves[int(rng.integers(0, len(waves)))]
        if len(w) < n:
            w = np.pad(w, (0, n - len(w)))
        start = int(rng.integers(0, max(len(w) - n, 1)))
        chunk = w[start: start + n]
        level = float(rng.uniform(0.0, 1.0)) if rng.uniform() > 0.3 else 0.0
        xs.append(degrade(chunk, sr, level, rng))
        ys.append(5.0 - 4.0 * level)
    return np.stack(xs), np.asarray(ys, np.float32)


def train_mos_proxy(waves: tp.Sequence[np.ndarray], sr: int = 24000, steps: int = 200,
                    batch: int = 8, chunk_s: float = 1.0, lr: float = 1e-3, seed: int = 0,
                    params: tp.Optional[MOSProxyParams] = None,
                    device: tp.Union[str, torch.device, None] = None) -> MOSProxy:
    """Fit a fresh ``MOSProxy`` (weights from ``torch.manual_seed(seed)``) for
    ``steps`` Adam steps of mean squared error against score = 5 - 4·level, on
    ``device`` (the GPU unless ``device="cpu"``); the batches are drawn with
    ``np.random.default_rng(seed)``, as the JAX trainer draws them."""
    from speechflow_torch.training.optimizer import OptimizerConfig, build_optimizer

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    model = MOSProxy(params or MOSProxyParams(sample_rate=sr)).to(dev)
    opt = build_optimizer(OptimizerConfig(method="adam", lr=lr, grad_clip=None), model)
    n = int(chunk_s * sr)
    for _ in range(steps):
        x, y = mos_batch(waves, sr, batch, n, rng)
        loss = torch.mean((model(torch.from_numpy(x).to(dev))
                           - torch.from_numpy(y).to(dev)) ** 2)
        loss.backward()
        opt.step()
    return model.eval()


class MOSProxyHook:
    """``(wav, sr) -> score`` (None when the waveform is shorter than one FFT):
    a ``MOSProxy`` or the ``save_module`` pickle of one (either package's),
    loaded on ``device`` (the GPU unless ``device="cpu"``)."""

    def __init__(self, model_or_ckpt, device: tp.Union[str, torch.device, None] = None):
        if isinstance(model_or_ckpt, (str, Path)):
            from speechflow_torch.utils.state_io import load_module

            self.model, _ = load_module(MOSProxy, MOSProxyParams, model_or_ckpt,
                                        device=device)
        else:
            self.model = model_or_ckpt

    @torch.no_grad()
    def __call__(self, wav: np.ndarray, sr: int) -> tp.Optional[float]:
        p = self.model.p
        if sr != p.sample_rate:
            from scipy.signal import resample_poly

            g = math.gcd(p.sample_rate, sr)
            wav = resample_poly(wav, p.sample_rate // g, sr // g)
        n = len(wav) - len(wav) % p.hop_length
        if n < p.n_fft:
            return None
        dev = next(self.model.parameters()).device
        x = torch.from_numpy(np.ascontiguousarray(wav[None, :n], np.float32)).to(dev)
        return float(self.model(x)[0])
