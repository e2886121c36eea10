"""Trainable CREPE-class pitch tracker (counterpart of
``speechflow_tpu/models/pitch/crepe.py``): a small conv net classifies each
analysis frame into ``n_bins`` log-spaced pitch bins, trained on synthetic
harmonic frames with known f0 (``synth_pitch_batch``) against Gaussian-blurred
one-hot targets by per-bin binary cross-entropy.

frame (N, W) -> per-frame normalisation -> [Conv1D (XLA SAME at its stride) ->
ReLU -> LayerNorm -> max-pool 2] x 4 -> dense -> per-bin logits. The network
is channels-last like the JAX module, so the dense layer reads the (T, C)
flattening that flax's does and takes its kernel as it is; each max-pool drops
an odd last step. ``decode`` is CREPE's weighted average of the activations
within ±``window`` bins of the peak on the cents scale, unvoiced (f0 = 0)
where the peak is not above ``threshold``. The bin centres are the
non-trainable ``cents`` (an ``nnx.Variable`` in JAX, in its checkpoints).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.models.layers import Conv1d, flax_init_, layer_norm
from speechflow_torch.training.base_model import BaseModelParams
from speechflow_torch.utils.device import resolve_device

__all__ = ["CrepeParams", "CrepeF0", "crepe_f0", "train_crepe", "synth_pitch_batch",
           "save_crepe", "load_crepe"]


@dataclasses.dataclass
class CrepeParams(BaseModelParams):
    sample_rate: int = 24000
    frame_length: int = 1024
    n_bins: int = 128
    f0_min: float = 50.0
    f0_max: float = 1100.0
    channels: tp.Tuple[int, ...] = (32, 32, 64, 64)
    kernel_sizes: tp.Tuple[int, ...] = (64, 16, 16, 16)
    strides: tp.Tuple[int, ...] = (4, 1, 1, 1)
    dense_dim: int = 128


def _bin_cents(p: CrepeParams) -> np.ndarray:
    """Bin centres on the cents scale (1200·log2(f / 10 Hz)), evenly spaced
    between f0_min and f0_max."""
    lo = 1200.0 * np.log2(p.f0_min / 10.0)
    hi = 1200.0 * np.log2(p.f0_max / 10.0)
    return np.linspace(lo, hi, p.n_bins).astype(np.float32)


class CrepeF0(nn.Module):
    def __init__(self, params: CrepeParams):
        super().__init__()
        p = self.p = params
        ins = [1] + list(p.channels[:-1])
        self.convs = nn.ModuleList(Conv1d(c, ch, k, stride=s) for c, ch, k, s in
                                   zip(ins, p.channels, p.kernel_sizes, p.strides))
        self.norms = nn.ModuleList(layer_norm(ch) for ch in p.channels)
        t = p.frame_length
        for s in p.strides:  # a SAME conv's ceil(t / s), then the max-pool's floor
            t = -(-t // s) // 2
        self.dense = nn.Linear(t * p.channels[-1], p.dense_dim)
        self.out = nn.Linear(p.dense_dim, p.n_bins)
        self.cents = nn.Parameter(torch.from_numpy(_bin_cents(p)), requires_grad=False)
        flax_init_(self)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, W) frames -> (N, n_bins) logits."""
        x = frames - frames.mean(-1, keepdim=True)
        x = x / (torch.sqrt((x ** 2).mean(-1, keepdim=True)) + 1e-5)
        x = x[..., None]
        for conv, norm in zip(self.convs, self.norms):
            x = norm(F.relu(conv(x)))
            n = x.shape[-2] - x.shape[-2] % 2
            x = torch.maximum(x[..., 0:n:2, :], x[..., 1:n:2, :])
        x = F.relu(self.dense(x.reshape(x.shape[0], -1)))
        return self.out(x)

    def decode(self, logits: torch.Tensor, threshold: float = 0.5, window: int = 4
               ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """(N, n_bins) logits -> (f0 in Hz, 0 where unvoiced; confidence)."""
        p = torch.sigmoid(logits)
        conf, center = p.max(-1)
        offs = torch.arange(-window, window + 1, device=logits.device)
        idx = torch.clamp(center[:, None] + offs[None, :], 0, logits.shape[-1] - 1)
        w = torch.gather(p, -1, idx)
        cents = (w * self.cents[idx]).sum(-1) / (w.sum(-1) + 1e-9)
        f0 = 10.0 * 2.0 ** (cents / 1200.0)
        return torch.where(conf > threshold, f0, torch.zeros_like(f0)), conf


def crepe_f0(model: CrepeF0, x: torch.Tensor, sr: tp.Optional[int] = None,
             hop_length: int = 256, threshold: float = 0.5) -> torch.Tensor:
    """(B, T) or (T,) waveform -> (B, 1 + T // hop) f0 in Hz (0 where
    unvoiced): frames centred as ``yin_f0``'s, the waveform zero-padded by
    W/2 before and W/2 + W after. ``sr``, when given, must be the model's."""
    from speechflow_torch.ops.stft import frame_signal

    p = model.p
    if sr is not None and int(sr) != int(p.sample_rate):
        raise ValueError(f"crepe tracker trained at {p.sample_rate} Hz, got audio at {sr} Hz")
    if x.ndim == 1:
        x = x[None]
    n_frames = 1 + x.shape[-1] // hop_length
    half = p.frame_length // 2
    xp = F.pad(x, (half, half + p.frame_length))
    frames = frame_signal(xp, p.frame_length, hop_length)[:, :n_frames]
    b = frames.shape[0]
    f0, _ = model.decode(model(frames.reshape(b * n_frames, p.frame_length)),
                         threshold=threshold)
    return f0.reshape(b, n_frames)


def synth_pitch_batch(rng: np.random.Generator, p: CrepeParams, batch: int,
                      voiced_frac: float = 0.85,
                      f0_range: tp.Tuple[float, float] = (60.0, 600.0),
                      label_sigma_bins: float = 1.5) -> tp.Tuple[np.ndarray, np.ndarray]:
    """(frames (B, W), targets (B, n_bins)), JAX's draws from ``rng`` in JAX's
    order. Voiced items: a harmonic signal with a slow f0 drift, random
    spectral decay, amplitudes and phases, noise at 5-40 dB SNR, the target a
    Gaussian (``label_sigma_bins`` bins) around the f0's bin; unvoiced items:
    one-pole low-passed noise, the target all zeros."""
    w = p.frame_length
    sr = p.sample_rate
    n = np.arange(w)
    frames = np.zeros((batch, w), np.float32)
    targets = np.zeros((batch, p.n_bins), np.float32)
    cents_grid = _bin_cents(p)
    for i in range(batch):
        if rng.uniform() < voiced_frac:
            f0 = np.exp(rng.uniform(np.log(f0_range[0]), np.log(f0_range[1])))
            drift = f0 * rng.uniform(-0.02, 0.02)
            f_inst = f0 + drift * (n / w - 0.5)
            phase = 2 * np.pi * np.cumsum(f_inst) / sr + rng.uniform(0, 2 * np.pi)
            n_harm = max(1, min(int(sr / 2 / f0) - 1, 24))
            gamma = rng.uniform(0.7, 2.5)
            sig = np.zeros(w)
            for k in range(1, n_harm + 1):
                a = k ** -gamma * rng.uniform(0.5, 1.5)
                sig += a * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
            sig /= max(np.abs(sig).max(), 1e-6)
            snr_db = rng.uniform(5.0, 40.0)
            noise = rng.standard_normal(w)
            noise *= np.sqrt((sig ** 2).mean()) / (
                np.sqrt((noise ** 2).mean()) + 1e-9) * 10 ** (-snr_db / 20)
            frames[i] = (sig + noise) * rng.uniform(0.05, 1.0)
            cents = 1200.0 * np.log2(f0 / 10.0)
            d = (cents_grid - cents) / (label_sigma_bins * (cents_grid[1] - cents_grid[0]))
            targets[i] = np.exp(-0.5 * d ** 2)
        else:
            a = rng.uniform(0.0, 0.95)
            e = rng.standard_normal(w)
            sig = np.zeros(w)
            acc = 0.0
            for j in range(w):
                acc = a * acc + (1 - a) * e[j]
                sig[j] = acc
            frames[i] = sig / max(np.abs(sig).max(), 1e-6) * rng.uniform(0.05, 1.0)
    return frames, targets


def train_crepe(params: tp.Optional[CrepeParams] = None, steps: int = 600, batch: int = 64,
                lr: float = 1e-3, seed: int = 0,
                device: tp.Union[str, torch.device, None] = None,
                losses: tp.Optional[tp.List[float]] = None) -> CrepeF0:
    """JAX's ``train_crepe``: ``steps`` ``optax.adamw(lr)`` steps (weight
    decay 1e-4, optax's default) of the mean per-bin binary cross-entropy on
    ``synth_pitch_batch`` batches drawn from ``numpy.random.default_rng(seed)``;
    the weights start from flax's initialisers under ``torch.manual_seed(seed)``.
    Trains on ``device`` (the GPU unless ``device="cpu"``) and returns the
    model in eval mode; each step's loss is appended to ``losses`` when given."""
    from speechflow_torch.training.optimizer import optax_optimizer

    p = params or CrepeParams()
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CrepeF0(p)
    model = model.to(dev).train()
    opt = optax_optimizer([q for q in model.parameters() if q.requires_grad], "adamw", lr)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        frames, targets = (torch.from_numpy(a).to(dev) for a in synth_pitch_batch(rng, p, batch))
        opt.zero_grad(set_to_none=True)
        loss = F.binary_cross_entropy_with_logits(model(frames), targets)
        loss.backward()
        opt.step()
        if losses is not None:
            losses.append(loss.detach())
    if losses is not None:
        losses[:] = [float(v) for v in losses]
    return model.eval()


def save_crepe(model: CrepeF0, path) -> None:
    from speechflow_torch.utils.state_io import save_module

    save_module(model, model.p, path)


def load_crepe(path, device: tp.Union[str, torch.device, None] = None) -> CrepeF0:
    """A tracker saved by either package's ``save_crepe``, on ``device`` (the
    GPU unless ``device="cpu"``)."""
    from speechflow_torch.utils.state_io import load_module

    return load_module(CrepeF0, CrepeParams, path, device=device)[0]
