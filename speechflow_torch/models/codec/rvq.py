"""Neural audio codec: strided-conv encoder, residual vector quantization and a
transposed-conv decoder (counterpart of ``speechflow_tpu/models/codec/rvq.py``).

Channels-last, as the JAX modules: a waveform (B, N) encodes to latents
(B, N/hop, latent_dim) through convs of kernel 2s at stride s with XLA SAME
padding (``models.layers.Conv1d``), ``ResidualVQ`` turns them into a code
grid (B, T', n_q), and the decoder mirrors the encoder with
``nnx.ConvTranspose`` of kernel 2s at stride s (``models.layers.ConvTranspose1d``:
SAME, the kernel unflipped, T·s outputs). ``codec_criterion`` is its
training loss: L1 + multi-resolution STFT + the RVQ's commitment loss.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.models.layers import Conv1d, ConvTranspose1d, layer_norm
from speechflow_torch.models.tts.common import VectorQuantizer
from speechflow_torch.training.base_model import BaseModelParams

__all__ = ["CodecParams", "ResidualVQ", "NeuralCodec", "CodecDecoder", "codec_criterion"]


@dataclasses.dataclass
class CodecParams(BaseModelParams):
    sample_rate: int = 24000
    channels: int = 64
    latent_dim: int = 128
    strides: tp.Tuple[int, ...] = (4, 4, 8)   # total hop = prod
    n_quantizers: int = 4
    codebook_size: int = 256


class ResidualVQ(nn.Module):
    def __init__(self, n_quantizers: int, codebook_size: int, dim: int):
        super().__init__()
        self.stages = nn.ModuleList(VectorQuantizer(codebook_size, dim)
                                    for _ in range(n_quantizers))

    def forward(self, z: torch.Tensor
                ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, T, D) -> (quantized, codes (B, T, n_q), mean stage loss): each
        stage quantizes what the stages before it left."""
        residual, quantized = z, torch.zeros_like(z)
        codes, total = [], 0.0
        for vq in self.stages:
            q, idx, loss = vq(residual)
            residual = residual - q.detach()
            quantized = quantized + q
            codes.append(idx)
            total = total + loss
        return quantized, torch.stack(codes, dim=-1), total / len(self.stages)

    def lookup(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, T, n_streams) int codes -> (B, T, D): the sum of each stage's
        codeword. Stage i reads stream min(i, n_streams - 1). That is what the
        JAX package computes: its ``lookup`` indexes ``codes[..., i]`` for every
        stage (``speechflow_tpu/models/codec/rvq.py:61-66``) and XTTS decodes a
        single stream (``speechflow_tpu/models/tts/xtts.py:151-152``); JAX clamps
        the out-of-range index, so every later stage reads the first stream's
        code. Torch would raise, so the clamp is written out."""
        n_streams = codes.shape[-1]
        out = 0.0
        for i, vq in enumerate(self.stages):
            out = out + vq.codebook[codes[..., min(i, n_streams - 1)]]
        return out


class CodecDecoder(nn.Module):
    """Latents (B, T, latent_dim) -> waveform (B, T·hop)."""

    def __init__(self, params: CodecParams):
        super().__init__()
        p = params
        ch = p.channels * (2 ** len(p.strides))
        self.dec_pre = Conv1d(p.latent_dim, ch, 3)
        self.dec = nn.ModuleList()
        for s in reversed(p.strides):
            self.dec.append(ConvTranspose1d(ch, ch // 2, 2 * s, s))
            ch //= 2
        self.dec_post = Conv1d(ch, 1, 7)
        self.hop = int(math.prod(p.strides))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = F.elu(self.dec_pre(z))
        for conv in self.dec:
            x = F.elu(conv(x))
        return torch.tanh(self.dec_post(x))[..., 0]


class NeuralCodec(nn.Module):
    def __init__(self, params: CodecParams):
        super().__init__()
        p = params
        self.p = p
        ch = p.channels
        self.enc_pre = Conv1d(1, ch, 7)
        self.enc = nn.ModuleList()
        for s in p.strides:
            self.enc.append(Conv1d(ch, ch * 2, 2 * s, stride=s))
            ch *= 2
        self.enc_post = Conv1d(ch, p.latent_dim, 3)
        self.enc_norm = layer_norm(p.latent_dim)  # bounded latents keep the RVQ stable
        self.rvq = ResidualVQ(p.n_quantizers, p.codebook_size, p.latent_dim)
        self.decoder = CodecDecoder(p)
        self.hop = self.decoder.hop

    def encode_latent(self, wav: torch.Tensor) -> torch.Tensor:
        x = F.elu(self.enc_pre(wav[..., None]))
        for conv in self.enc:
            x = F.elu(conv(x))
        return self.enc_norm(self.enc_post(x))

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, wav: torch.Tensor
                ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Training forward: (reconstruction cut to the input's length, codes,
        vq loss)."""
        q, codes, vq_loss = self.rvq(self.encode_latent(wav))
        return self.decode_latent(q)[..., : wav.shape[-1]], codes, vq_loss

    def encode(self, wav: torch.Tensor) -> torch.Tensor:
        return self.rvq(self.encode_latent(wav))[1]

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.decode_latent(self.rvq.lookup(codes))


def codec_criterion(sample_rate: int = 24000, vq_weight: float = 1.0,
                    stft_weight: float = 1.0) -> tp.Callable:
    """The codec's losses for ``Trainer``: ``criterion(outputs, targets, step)``
    with ``outputs`` the training forward's (reconstruction, codes, vq loss) and
    ``targets["waveform"]`` cut to the reconstruction's length -> {"l1", "stft"
    (at resolutions (512, 128) and (1024, 256)), "vq"}. ``sample_rate`` is
    accepted and unused, as in the JAX criterion."""
    from speechflow_torch.models.vocoder.criterion import multires_stft_loss

    def criterion(outputs, targets, step):
        recon, _, vq_loss = outputs
        real = targets["waveform"][..., : recon.shape[-1]]
        return {"l1": torch.mean(torch.abs(recon - real)),
                "stft": stft_weight * multires_stft_loss(
                    recon, real, resolutions=((512, 128), (1024, 256))),
                "vq": vq_weight * vq_loss}

    return criterion
