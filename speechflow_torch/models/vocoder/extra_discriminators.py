"""More vocoder discriminators (counterpart of
``speechflow_tpu/models/vocoder/extra_discriminators.py``): the multi-band
STFT discriminator, the true CQT discriminator and its multi-scale sub-band
ensemble (the flagship recipe's, over ``ops.cqt``), and the log-frequency
STFT-filterbank variant. Channels-last (B, H, W, C), SAME padding, the JAX
module and parameter names."""

from __future__ import annotations

import functools
import typing as tp

import numpy as np
import torch
import torch.nn as nn

from speechflow_torch.models.layers import Conv2d, flax_init_
from speechflow_torch.models.vocoder.discriminators import Output, run_stack
from speechflow_torch.ops.cqt import cqt
from speechflow_torch.ops.stft import magnitude, stft

__all__ = ["MultiBandDiscriminator", "LogFreqDiscriminator",
           "MultiScaleLogFreqDiscriminator", "DiscriminatorCQT",
           "MultiScaleSubbandCQTDiscriminator"]


class _Conv2DStack(nn.Module):
    def __init__(self, ch_in: int, channels: int):
        super().__init__()
        c = channels
        self.convs = nn.ModuleList([
            Conv2d(ch_in, c, (3, 9)), Conv2d(c, c, (3, 9), stride=(1, 2)),
            Conv2d(c, c, (3, 9), stride=(1, 2)), Conv2d(c, c, (3, 3))])
        self.post = Conv2d(c, 1, (3, 3))
        flax_init_(self)

    def forward(self, x: torch.Tensor) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        return run_stack(self.convs, self.post, x)


class MultiBandDiscriminator(nn.Module):
    """One conv stack per frequency band of one STFT magnitude."""

    def __init__(self, n_fft: int = 1024, hop_length: int = 256,
                 bands: tp.Sequence[tp.Tuple[float, float]] = (
                     (0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 1.0)),
                 channels: int = 32):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        n_bins = n_fft // 2 + 1
        self.band_slices = [(int(b * n_bins), max(int(e * n_bins), int(b * n_bins) + 4))
                            for b, e in bands]
        self.stacks = nn.ModuleList(_Conv2DStack(1, channels) for _ in bands)

    def forward(self, wav: torch.Tensor) -> Output:
        mag = magnitude(wav, self.n_fft, self.hop_length)  # (B, T, F)
        outs = [stack(mag[:, :, b:e, None]) for (b, e), stack in
                zip(self.band_slices, self.stacks)]
        return [o[0] for o in outs], [o[1] for o in outs]


@functools.lru_cache(maxsize=None)
def _logfreq_fb(n_fft: int, sr: int, n_bins: int, fmin: float) -> np.ndarray:
    """Constant-Q-spaced triangular filterbank over linear FFT bins."""
    lin = np.linspace(0, sr / 2, n_fft // 2 + 1)
    fmax = sr / 2
    centers = fmin * (fmax / fmin) ** (np.arange(n_bins + 2) / (n_bins + 1))
    fb = np.zeros((n_bins, len(lin)), np.float32)
    for i in range(n_bins):
        lo, c, hi = centers[i], centers[i + 1], centers[i + 2]
        up = (lin - lo) / max(c - lo, 1e-6)
        down = (hi - lin) / max(hi - c, 1e-6)
        fb[i] = np.clip(np.minimum(up, down), 0, 1)
    return fb


class LogFreqDiscriminator(nn.Module):
    def __init__(self, n_fft: int = 1024, hop_length: int = 256, sr: int = 24000,
                 n_bins: int = 84, fmin: float = 32.7, channels: int = 32):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.register_buffer("fb", torch.from_numpy(_logfreq_fb(n_fft, sr, n_bins, fmin)),
                             persistent=False)
        self.stack = _Conv2DStack(2, channels)

    def forward(self, wav: torch.Tensor) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        spec = stft(wav, self.n_fft, self.hop_length)  # complex (B, T, F)
        with torch.autocast(device_type=wav.device.type, enabled=False):
            x = torch.stack([torch.matmul(spec.real, self.fb.T),
                             torch.matmul(spec.imag, self.fb.T)], dim=-1)
        return self.stack(x)


class MultiScaleLogFreqDiscriminator(nn.Module):
    def __init__(self, scales: tp.Sequence[tp.Tuple[int, int]] = (
            (512, 128), (1024, 256), (2048, 512)), sr: int = 24000, channels: int = 32):
        super().__init__()
        self.discs = nn.ModuleList(LogFreqDiscriminator(n, h, sr, channels=channels)
                                   for n, h in scales)

    def forward(self, wav: torch.Tensor) -> Output:
        outs = [d(wav) for d in self.discs]
        return [o[0] for o in outs], [o[1] for o in outs]


class DiscriminatorCQT(nn.Module):
    """One CQT scale: complex CQT -> (real, imag) channels -> per-octave
    pre-convs -> frequency concat -> time-dilated conv stack with frequency
    stride 2 -> post conv."""

    def __init__(self, sr: int, hop_length: int = 512, n_octaves: int = 9,
                 bins_per_octave: int = 24, filters: int = 32, max_filters: int = 1024,
                 dilations: tp.Sequence[int] = (1, 2, 4)):
        super().__init__()
        self.sr = sr
        self.hop_length = hop_length
        self.n_octaves = n_octaves
        self.bins_per_octave = bins_per_octave
        self.conv_pres = nn.ModuleList(Conv2d(2, 2, (3, 9)) for _ in range(n_octaves))
        convs = [Conv2d(2, filters, (3, 9))]
        in_ch = filters
        for i, d in enumerate(dilations):
            out_ch = min(filters * (2 ** (i + 1)), max_filters)
            convs.append(Conv2d(in_ch, out_ch, (3, 9), stride=(1, 2), dilation=(d, 1)))
            in_ch = out_ch
        convs.append(Conv2d(in_ch, in_ch, (3, 3)))
        self.convs = nn.ModuleList(convs)
        self.post = Conv2d(in_ch, 1, (3, 3))
        flax_init_(self)

    def forward(self, wav: torch.Tensor) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        z = cqt(wav, self.sr, self.hop_length, n_octaves=self.n_octaves,
                bins_per_octave=self.bins_per_octave)  # (B, T, F, 2) float32
        n = self.bins_per_octave
        x = torch.cat([pre(z[:, :, o * n:(o + 1) * n]) for o, pre in
                       enumerate(self.conv_pres)], dim=2)
        return run_stack(self.convs, self.post, x)


class MultiScaleSubbandCQTDiscriminator(nn.Module):
    """Three CQT scales: hops 512/256/256 at the 2x working rate, 9 octaves,
    24/36/48 bins per octave."""

    def __init__(self, sr: int = 24000, hop_lengths: tp.Sequence[int] = (512, 256, 256),
                 n_octaves: tp.Sequence[int] = (9, 9, 9),
                 bins_per_octave: tp.Sequence[int] = (24, 36, 48), filters: int = 32):
        super().__init__()
        self.discs = nn.ModuleList(DiscriminatorCQT(sr, h, o, b, filters=filters)
                                   for h, o, b in zip(hop_lengths, n_octaves, bins_per_octave))

    def forward(self, wav: torch.Tensor) -> Output:
        outs = [d(wav) for d in self.discs]
        return [o[0] for o in outs], [o[1] for o in outs]
