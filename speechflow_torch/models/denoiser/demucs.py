"""Trainable waveform denoiser, a DEMUCS-class U-Net (counterpart of
``speechflow_tpu/models/denoiser/demucs.py``): strided-conv encoder layers
with GLU gates, a bidirectional GRU bottleneck, and a transposed-conv decoder
with skip connections, over the waveform divided by its standard deviation
(restored on output).

Channels-last as the JAX module: the encoder convs are ``nnx.Conv`` with XLA
SAME padding at their stride (``models.layers.Conv1d``), the decoder's
``nnx.ConvTranspose(..., padding="SAME")`` correlates with its kernel
unflipped (``models.layers.ConvTranspose1d``), the GRUs are ``nnx.RNN`` over
every step (the backward one ``reverse=True, keep_order=True``), and the
standard deviation is ``jnp.std``'s, ddof 0. The weights start from flax's
initialisers.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.models.layers import RNN, Conv1d, ConvTranspose1d, flax_init_
from speechflow_torch.training.base_model import BaseModelParams

__all__ = ["WaveDenoiserParams", "WaveDenoiser", "denoiser_criterion"]


@dataclasses.dataclass
class WaveDenoiserParams(BaseModelParams):
    channels: int = 48
    depth: int = 4
    kernel_size: int = 8
    stride: int = 4
    growth: float = 2.0
    use_rnn: bool = True
    sample_rate: int = 24000


class WaveDenoiser(nn.Module):
    def __init__(self, params: WaveDenoiserParams):
        super().__init__()
        p = self.p = params
        ch_in, ch = 1, p.channels
        chs = []
        self.encoder = nn.ModuleList()
        for _ in range(p.depth):
            self.encoder.append(nn.ModuleList([
                Conv1d(ch_in, ch, p.kernel_size, stride=p.stride),
                Conv1d(ch, 2 * ch, 1)]))  # GLU gate
            chs.append((ch_in, ch))
            ch_in, ch = ch, int(ch * p.growth)
        bottleneck = ch_in
        self.use_rnn = p.use_rnn
        if p.use_rnn:
            half = bottleneck // 2
            self.fwd = RNN("gru", bottleneck, half)
            self.bwd = RNN("gru", bottleneck, bottleneck - half, reverse=True)
        self.decoder = nn.ModuleList(
            nn.ModuleList([Conv1d(dec_out, 2 * dec_out, 1),  # GLU gate
                           ConvTranspose1d(dec_out, dec_in, p.kernel_size, p.stride)])
            for dec_in, dec_out in reversed(chs))
        self.total_stride = p.stride ** p.depth
        flax_init_(self)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) noisy -> (B, T) denoised (T padded with zeros to a multiple
        of stride**depth inside)."""
        std = torch.std(wav, dim=-1, keepdim=True, correction=0) + 1e-5
        x = (wav / std)[..., None]
        n = x.shape[1]
        x = F.pad(x, (0, 0, 0, (-n) % self.total_stride))
        skips = []
        for conv, gate in self.encoder:
            x = F.glu(gate(F.relu(conv(x))), dim=-1)
            skips.append(x)
        if self.use_rnn:
            x = torch.cat([self.fwd(x), self.bwd(x)], dim=-1)
        for (gate, deconv), skip in zip(self.decoder, reversed(skips)):
            x = x + skip[:, :x.shape[1]]
            x = deconv(F.glu(gate(x), dim=-1))
        return x[:, :n, 0] * std


def denoiser_criterion(stft_weight: float = 0.5) -> tp.Callable:
    """``criterion(outputs, targets, step)``: L1 to ``targets["clean"]`` plus
    ``stft_weight`` x the multi-resolution STFT loss (the ``Trainer``'s
    contract)."""
    from speechflow_torch.models.vocoder.criterion import multires_stft_loss

    def criterion(outputs, targets, step) -> tp.Dict[str, torch.Tensor]:
        clean = targets["clean"][..., :outputs.shape[-1]]
        losses = {"l1": torch.mean(torch.abs(outputs - clean))}
        if stft_weight > 0:
            losses["stft"] = stft_weight * multires_stft_loss(outputs, clean)
        return losses

    return criterion
