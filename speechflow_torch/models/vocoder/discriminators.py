"""GAN discriminators of the vocoder (counterpart of
``speechflow_tpu/models/vocoder/discriminators.py``): ``PeriodDiscriminator``
and the MPD over them, ``ResolutionDiscriminator`` and the MRD over STFT
magnitudes, and ``VocoderDiscriminator``, the MPD paired with the MRD or, with
``use_cqt``, with the multi-scale sub-band CQT discriminator.

Each returns (logits list, feature-map list). The 2-D convs keep the JAX
package's channels-last layout at their boundaries ((B, H, W, C) feature
maps) and its SAME padding with strides (``layers.Conv2d``); the module and
parameter names follow the JAX modules, so ``convert`` maps one onto the other.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.models.layers import Conv2d, flax_init_
from speechflow_torch.ops.stft import magnitude

__all__ = ["PeriodDiscriminator", "MultiPeriodDiscriminator", "ResolutionDiscriminator",
           "MultiResolutionDiscriminator", "VocoderDiscriminator", "leaky_relu", "run_stack"]

Output = tp.Tuple[tp.List[torch.Tensor], tp.List[tp.List[torch.Tensor]]]


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    """``nnx.leaky_relu``: at exactly 0 the slope is 1, as JAX's ``where(x >= 0, ...)``
    gives it (torch's takes ``negative_slope`` there). Exact zeros are common: a
    discriminator's biases start at 0 and stay there through the warmup's lr-0 step,
    and a chunk's silence and padding give conv outputs of exactly the bias."""
    return torch.where(x >= 0, x, x * negative_slope)


def run_stack(convs: nn.ModuleList, post: nn.Module, x: torch.Tensor
              ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
    """Convs with LeakyReLU(0.1), then the post conv: (logits (B, -1), feature maps)."""
    fmaps = []
    for conv in convs:
        x = leaky_relu(conv(x), 0.1)
        fmaps.append(x)
    logits = post(x)
    fmaps.append(logits)
    return logits.reshape(x.shape[0], -1), fmaps


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int, channels: int = 32):
        super().__init__()
        self.period = period
        chs = [1, channels, channels * 4, channels * 16, channels * 32, channels * 32]
        self.convs = nn.ModuleList(
            Conv2d(chs[i], chs[i + 1], (5, 1), stride=(3, 1) if i < 4 else (1, 1))
            for i in range(5))
        self.post = Conv2d(chs[-1], 1, (3, 1))
        flax_init_(self)

    def forward(self, wav: torch.Tensor) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        """(B, T) -> the waveform reflect-padded to a multiple of the period and
        folded to (B, T/p, p, 1) channels-last."""
        b, t = wav.shape
        pad = (-t) % self.period
        x = F.pad(wav[:, None], (0, pad), mode="reflect")[:, 0] if pad else wav
        return run_stack(self.convs, self.post, x.reshape(b, -1, self.period, 1))


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: tp.Sequence[int] = (2, 3, 5, 7, 11), channels: int = 32):
        super().__init__()
        self.discs = nn.ModuleList(PeriodDiscriminator(p, channels) for p in periods)

    def forward(self, wav: torch.Tensor) -> Output:
        outs = [d(wav) for d in self.discs]
        return [o[0] for o in outs], [o[1] for o in outs]


class ResolutionDiscriminator(nn.Module):
    def __init__(self, n_fft: int, hop_length: int, channels: int = 32):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        c = channels
        self.convs = nn.ModuleList([
            Conv2d(1, c, (7, 5), stride=(2, 2)), Conv2d(c, c, (5, 3), stride=(2, 1)),
            Conv2d(c, c, (5, 3), stride=(2, 2)), Conv2d(c, c, (3, 3), stride=(2, 1)),
            Conv2d(c, c, (3, 3), stride=(2, 2))])
        self.post = Conv2d(c, 1, (3, 3))
        flax_init_(self)

    def forward(self, wav: torch.Tensor) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        mag = magnitude(wav, self.n_fft, self.hop_length)  # (B, T, F) float32
        return run_stack(self.convs, self.post, mag[..., None])


class MultiResolutionDiscriminator(nn.Module):
    def __init__(self, resolutions: tp.Sequence[tp.Tuple[int, int]] = (
            (1024, 256), (2048, 512), (512, 128)), channels: int = 32):
        super().__init__()
        self.discs = nn.ModuleList(ResolutionDiscriminator(n, h, channels)
                                   for n, h in resolutions)

    def forward(self, wav: torch.Tensor) -> Output:
        outs = [d(wav) for d in self.discs]
        return [o[0] for o in outs], [o[1] for o in outs]


class VocoderDiscriminator(nn.Module):
    """MPD + MRD, or MPD + the sub-band CQT discriminator with ``use_cqt``."""

    def __init__(self, periods=(2, 3, 5, 7, 11),
                 resolutions=((1024, 256), (2048, 512), (512, 128)),
                 channels: int = 32, use_cqt: bool = False, sample_rate: int = 24000,
                 cqt_bins_per_octave=(24, 36, 48), cqt_n_octaves=(9, 9, 9)):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(periods, channels)
        if use_cqt:
            from speechflow_torch.models.vocoder.extra_discriminators import (
                MultiScaleSubbandCQTDiscriminator,
            )

            self.mrd = MultiScaleSubbandCQTDiscriminator(
                sr=sample_rate, n_octaves=tuple(cqt_n_octaves),
                bins_per_octave=tuple(cqt_bins_per_octave), filters=channels)
        else:
            self.mrd = MultiResolutionDiscriminator(resolutions, channels)

    def forward(self, wav: torch.Tensor) -> Output:
        l1, f1 = self.mpd(wav)
        l2, f2 = self.mrd(wav)
        return l1 + l2, f1 + f2
