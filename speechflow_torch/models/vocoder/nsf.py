"""NSF heads: F0-driven source-filter synthesis with AdaIN styling (counterpart
of ``speechflow_tpu/models/vocoder/nsf.py``).

``SineGen`` turns a frame-level F0 into a harmonic sine source at the sample
rate (a cumulative-phase oscillator, noise where unvoiced) plus a noise
channel. ``NSFHiFiGANHead`` merges that source, downsampled by strided convs,
into each transposed-conv upsampling stage, followed by a residual block whose
norms are ``AdaIN`` over a style embedding. ``NSFiSTFTHead`` concatenates the
pooled source to the hidden stream and predicts an ISTFT's magnitude and phase.

The JAX ``SineGen`` draws both normals from one key of the model's rng stream
inside the call; here they come from ``noise`` (a pair of standard normals of
shapes (B, S, H) and (B, S, 1)) or are drawn from ``generator``. The source is
computed in float32 whatever the autocast, from a phase accumulated in float64
and reduced to one cycle (the JAX package sums it in float32, whose rounding
then depends on the order of the sum: the card's scan and the CPU's loop differ by
~1e-4 rad after a few seconds).
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
import torch.nn as nn

from speechflow_torch.models.layers import Conv1d, ConvTranspose1d, flax_init_
from speechflow_torch.models.vocoder.discriminators import leaky_relu
from speechflow_torch.ops.stft import istft

__all__ = ["SineGen", "AdaIN", "NSFHiFiGANHead", "NSFiSTFTHead"]

Noise = tp.Optional[tp.Tuple[torch.Tensor, torch.Tensor]]


class SineGen(nn.Module):
    """Frame-level F0 (Hz) -> a harmonic source at the sample rate."""

    def __init__(self, sample_rate: int = 24000, n_harmonics: int = 8, amp: float = 0.1,
                 noise_std: float = 0.003, voiced_threshold: float = 10.0):
        super().__init__()
        self.sample_rate = sample_rate
        self.n_harmonics = n_harmonics
        self.amp = amp
        self.noise_std = noise_std
        self.voiced_threshold = voiced_threshold

    def draw(self, b: int, s: int, device, generator: tp.Optional[torch.Generator] = None
             ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """The two standard normals of one call: (B, S, H) and (B, S, 1)."""
        return (torch.randn(b, s, self.n_harmonics, device=device, generator=generator),
                torch.randn(b, s, 1, device=device, generator=generator))

    def forward(self, f0_frames: torch.Tensor, hop: int, noise: Noise = None,
                generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T) F0 -> (B, T·hop, n_harmonics + 1) float32: the voiced sines
        (amplitude ``amp``) with small noise, noise alone (amp/3) where unvoiced,
        and a noise channel."""
        b, t = f0_frames.shape
        with torch.autocast(f0_frames.device.type, enabled=False):
            f0 = f0_frames.float().repeat_interleave(hop, dim=1)      # nearest hold
            voiced = (f0 > self.voiced_threshold).float()[..., None]
            # cycles accumulated in float64 and reduced to [0, 1): a float32 running sum
            # over a long utterance carries an order-dependent error of ~1e-4 rad
            cycles = torch.cumsum(f0.double() / self.sample_rate, dim=1)
            phase = (2 * math.pi * (cycles - torch.floor(cycles))).float()
            h = torch.arange(1, self.n_harmonics + 1, dtype=torch.float32, device=f0.device)
            sines = torch.sin(phase[..., None] * h)
            n1, n2 = noise if noise is not None else self.draw(b, t * hop, f0.device, generator)
            nz = n1.float() * self.noise_std
            unvoiced_gain = self.amp / 3 / self.noise_std
            source = self.amp * sines * voiced + nz * (voiced + (1 - voiced) * unvoiced_gain)
            return torch.cat([source, n2.float() * self.noise_std], dim=-1)


class AdaIN(nn.Module):
    """Instance norm over time (population std + 1e-5) with a style-predicted
    affine (1 + scale, shift); without a style, the norm alone."""

    def __init__(self, channels: int, style_dim: int):
        super().__init__()
        self.proj = nn.Linear(style_dim, 2 * channels)

    def forward(self, x: torch.Tensor, style: tp.Optional[torch.Tensor]) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        std = x.std(dim=1, keepdim=True, correction=0) + 1e-5
        x = (x - mean) / std
        if style is None:
            return x
        scale, shift = self.proj(style)[:, None, :].chunk(2, dim=-1)
        return x * (1.0 + scale) + shift


class _StyledResBlock(nn.Module):
    def __init__(self, channels: int, style_dim: int, kernel_size: int = 3,
                 dilations: tp.Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs = nn.ModuleList(Conv1d(channels, channels, kernel_size, dilation=d)
                                   for d in dilations)
        self.norms = nn.ModuleList(AdaIN(channels, style_dim) for _ in dilations)

    def forward(self, x: torch.Tensor, style: tp.Optional[torch.Tensor]) -> torch.Tensor:
        for norm, conv in zip(self.norms, self.convs):
            x = x + conv(leaky_relu(norm(x, style), 0.1))
        return x


class NSFHiFiGANHead(nn.Module):
    """Hidden (B, T, dim) + F0 (B, T) -> (B, T·prod(rates)) waveform: per stage a
    transposed conv (kernel 2r, stride r), the source through a conv of kernel
    2·cum + 1 at stride cum (cum: the rates still to come), both cut to the
    shorter, then a styled residual block."""

    def __init__(self, dim: int = 512, upsample_rates: tp.Sequence[int] = (8, 8, 2, 2),
                 channels: int = 256, style_dim: int = 128, sample_rate: int = 24000,
                 n_harmonics: int = 8):
        super().__init__()
        self.sine_gen = SineGen(sample_rate, n_harmonics)
        self.upsample_rates = tuple(upsample_rates)
        self.total_up = int(np.prod(upsample_rates))
        self.pre = Conv1d(dim, channels, 7)
        self.ups = nn.ModuleList()
        self.source_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch, cum = channels, self.total_up
        for r in upsample_rates:
            self.ups.append(ConvTranspose1d(ch, ch // 2, 2 * r, r))
            ch //= 2
            cum //= r
            self.source_convs.append(Conv1d(n_harmonics + 1, ch, cum * 2 + 1, stride=cum))
            self.resblocks.append(_StyledResBlock(ch, style_dim))
        self.post = Conv1d(ch, 1, 7)
        flax_init_(self)

    def forward(self, x: torch.Tensor, f0_frames: torch.Tensor,
                style: tp.Optional[torch.Tensor] = None, noise: Noise = None,
                generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
        source = self.sine_gen(f0_frames, self.total_up, noise, generator)
        h = self.pre(x)
        for up, sconv, res in zip(self.ups, self.source_convs, self.resblocks):
            h = up(leaky_relu(h, 0.1))
            s = sconv(source.to(h.dtype))
            t = min(h.shape[1], s.shape[1])
            h = res(h[:, :t] + s[:, :t], style)
        return torch.tanh(self.post(h))[..., 0]


class NSFiSTFTHead(nn.Module):
    """Hidden (B, T, dim) + F0 -> waveform: the source pooled to the frame rate
    (a conv of kernel 2·hop + 1 at stride hop, 64 channels) beside the AdaIN'd
    hidden stream, a linear to n_fft + 2, magnitude exp(min(m, 10)) and phase,
    then the ISTFT (complex64, float32 out)."""

    def __init__(self, dim: int = 512, n_fft: int = 1024, hop_length: int = 256,
                 style_dim: int = 128, sample_rate: int = 24000, n_harmonics: int = 8):
        super().__init__()
        self.sine_gen = SineGen(sample_rate, n_harmonics)
        self.hop = hop_length
        self.n_fft = n_fft
        self.source_pool = Conv1d(n_harmonics + 1, 64, hop_length * 2 + 1, stride=hop_length)
        self.norm = AdaIN(dim, style_dim)
        self.out = nn.Linear(dim + 64, n_fft + 2)
        flax_init_(self)

    def forward(self, x: torch.Tensor, f0_frames: torch.Tensor,
                style: tp.Optional[torch.Tensor] = None, noise: Noise = None,
                generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
        source = self.sine_gen(f0_frames, self.hop, noise, generator)
        source = self.source_pool(source.to(x.dtype))
        t = min(x.shape[1], source.shape[1])
        h = torch.cat([self.norm(x[:, :t], style), source[:, :t].to(x.dtype)], dim=-1)
        mag, phase = self.out(h).float().chunk(2, dim=-1)
        spec = torch.polar(torch.exp(torch.clamp(mag, max=10.0)), phase)
        return istft(spec, self.n_fft, self.hop)
