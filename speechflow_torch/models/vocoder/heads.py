"""Vocoder heads (counterpart of ``speechflow_tpu/models/vocoder/heads.py``):
``ISTFTHead`` (per-frame magnitude and phase, inverted by ``ops.stft.istft``),
the BigVGAN-class ``SnakeUpsampleHead`` with its ``AntiAliasedSnake`` and
``ResBlock``, the MDCT heads ``IMDCTSymExpHead`` and ``IMDCTCosHead`` (per-frame
MDCT coefficients through a fixed windowed basis, overlap-added at hop = frame
length), and ``DACHead`` (a projection into the codec's latent space and the
codec's transposed-conv decoder, ``models/codec/rvq.py::CodecDecoder``).

Every activation goes through the hand-written anti-alias kernel
(``speechflow_torch.ops.anti_alias``) on the GPU. Within a
multi-receptive-field group every branch's first activation sees the same
input, so the interpolation FIR (``aa_upsample_fir``) runs once per group
and each branch applies only its snake and decimation
(``aa_snake_downsample``) — exact, as in the JAX head.

``remat`` is JAX's keyword (on by default), accepted for its API and its
params, and it changes nothing: on the GPU the kernels' autograd Functions
always keep only an activation's inputs and recompute it in the backward
pass, whatever ``remat`` says.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn as nn

from speechflow_torch.models.layers import Conv1d, ConvTranspose1d, flax_init_
from speechflow_torch.ops.anti_alias import (
    aa_snake_downsample,
    aa_upsample_fir,
    anti_alias_snake,
)
from speechflow_torch.ops.stft import istft, overlap_add

__all__ = ["ISTFTHead", "AntiAliasedSnake", "ResBlock", "SnakeUpsampleHead", "DACHead",
           "IMDCTSymExpHead", "IMDCTCosHead"]


class ISTFTHead(nn.Module):
    """Linear to n_fft + 2 -> magnitude exp(min(m, 10)) and phase -> ISTFT.

    The spectrum is built in complex64 from the projection cast to float32
    (cuFFT has no bf16 transform of this kind), as the JAX head builds
    complex64 from its projection; the waveform comes out in float32.
    """

    def __init__(self, dim: int = 512, n_fft: int = 1024, hop_length: int = 256):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.out = nn.Linear(dim, n_fft + 2)
        flax_init_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, dim) -> (B, (T-1)·hop) waveform (a centered ISTFT of T frames)."""
        mag, phase = self.out(x).float().chunk(2, dim=-1)
        spec = torch.polar(torch.exp(torch.clamp(mag, max=10.0)), phase)
        return istft(spec, self.n_fft, self.hop_length)


class AntiAliasedSnake(nn.Module):
    """upsample 2x (FIR) -> snake-beta -> FIR -> downsample 2x."""

    def __init__(self, channels: int, taps: int = 12, remat: bool = True):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.taps = taps
        self.remat = remat  # recomputed always (see the module docstring)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return anti_alias_snake(x, self.alpha, self.beta, self.taps)

    def from_shared(self, y_even: torch.Tensor, y_odd: torch.Tensor) -> torch.Tensor:
        """Snake + decimation on a precomputed (shared) stage-1 pair."""
        return aa_snake_downsample(y_even, y_odd, self.alpha, self.beta, self.taps)


class ResBlock(nn.Module):
    """AMP residual block: dilated SAME convs after anti-aliased snakes."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: tp.Sequence[int] = (1, 3, 5), taps: int = 12,
                 remat: bool = True):
        super().__init__()
        self.convs = nn.ModuleList(Conv1d(channels, channels, kernel_size, dilation=d)
                                   for d in dilations)
        self.acts = nn.ModuleList(AntiAliasedSnake(channels, taps, remat) for _ in dilations)

    def forward(self, x: torch.Tensor, shared_stage1=None) -> torch.Tensor:
        for i, (act, conv) in enumerate(zip(self.acts, self.convs)):
            a = act.from_shared(*shared_stage1) if i == 0 and shared_stage1 is not None \
                else act(x)
            x = x + conv(a)
        return x


class SnakeUpsampleHead(nn.Module):
    """Stacked transposed-conv upsampling, each stage followed by the mean of
    parallel AMP resblocks (kernels ``resblock_kernel_sizes``)."""

    def __init__(self, dim: int = 512, upsample_rates: tp.Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: tp.Optional[tp.Sequence[int]] = None,
                 channels: int = 256, resblock_kernel_sizes: tp.Sequence[int] = (3,),
                 taps: int = 12, remat: bool = True):
        super().__init__()
        upsample_kernel_sizes = upsample_kernel_sizes or [2 * r for r in upsample_rates]
        self.pre = Conv1d(dim, channels, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        self.taps = taps
        ch = channels
        for r, k in zip(upsample_rates, upsample_kernel_sizes):
            self.ups.append(ConvTranspose1d(ch, ch // 2, k, r))
            ch //= 2
            self.resblocks.append(nn.ModuleList(ResBlock(ch, ks, taps=taps, remat=remat)
                                                for ks in resblock_kernel_sizes))
        self.post_act = AntiAliasedSnake(ch, taps, remat)
        self.post = Conv1d(ch, 1, 7)
        self.total_upsample = int(np.prod(upsample_rates))
        flax_init_(self)  # snake α and β stay 0 (log scale), as in JAX

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, dim) -> (B, T·prod(rates)) waveform."""
        x = self.pre(x)
        for up, group in zip(self.ups, self.resblocks):
            x = self.mrf(group, up(x))
        x = self.post(self.post_act(x))
        return torch.tanh(x)[..., 0]

    def mrf(self, group: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
        """The mean of an MRF group's branches over one stage's input."""
        s1 = aa_upsample_fir(x, self.taps) if len(group) > 1 else None
        acc = group[0](x, shared_stage1=s1)
        for res in group[1:]:
            acc = acc + res(x, shared_stage1=s1)
        return acc / len(group)


def _factor_strides(hop: int, max_stride: int = 8) -> tp.Tuple[int, ...]:
    """``hop`` as transposed-conv strides of at most ``max_stride``, largest
    first (256 -> (8, 8, 4)), so the codec decoder upsamples by exactly the hop."""
    strides = []
    rem = hop
    while rem > 1:
        for s in range(min(max_stride, rem), 1, -1):
            if rem % s == 0:
                strides.append(s)
                rem //= s
                break
        else:
            raise ValueError(f"cannot factor hop {hop} into strides <= {max_stride}")
    return tuple(strides)


class DACHead(nn.Module):
    """Backbone hidden states -> the codec's latent space (``proj``) -> the
    codec decoder (decoder only; its strides default to the hop's factors, and
    a decoder whose upsampling is not the hop raises). No 10x latent rescale:
    the decoder trains with the vocoder."""

    def __init__(self, dim: int, hop_length: int = 256,
                 codec_params: tp.Optional[dict] = None):
        super().__init__()
        from speechflow_torch.models.codec.rvq import CodecDecoder, CodecParams

        cp = dict(codec_params or {})
        cp.setdefault("strides", _factor_strides(hop_length))
        params = CodecParams.create(cp)
        self.decoder = CodecDecoder(params)
        if self.decoder.hop != hop_length:
            raise ValueError(f"codec strides {cp['strides']} upsample x{self.decoder.hop}, "
                             f"but the vocoder hop is {hop_length}")
        self.proj = nn.Linear(dim, params.latent_dim)
        flax_init_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, dim) -> (B, T·hop) waveform."""
        return self.decoder(self.proj(x))


def _mdct_basis(frame_len: int) -> np.ndarray:
    """The DCT-IV-style basis (2N, N) of an MDCT of window length 2N, float32."""
    n = frame_len
    k = np.arange(n)[None, :]
    t = np.arange(2 * n)[:, None]
    return np.cos(np.pi / n * (t + 0.5 + n / 2) * (k + 0.5)).astype(np.float32)


class _IMDCTHead(nn.Module):
    """Linear -> MDCT coefficients (``_coeffs``) -> frames through the sine-windowed
    basis -> overlap-add at hop = ``mdct_frame_len``, cropped by half a hop to
    T·hop samples. The windowed basis is the JAX head's constant, built once in
    numpy (float32 basis, float64 window): a parameter that does not train, so
    checkpoints of either package carry it."""

    def __init__(self, dim: int, mdct_frame_len: int = 512, out_mult: int = 1):
        super().__init__()
        n = self.frame_len = mdct_frame_len
        self.out = nn.Linear(dim, out_mult * n)
        basis = _mdct_basis(n) * (2.0 / n)
        window = np.sin(np.pi / (2 * n * 2) * (np.arange(2 * n) * 2 + 1))
        self.basis = nn.Parameter(torch.from_numpy((basis * window[:, None]).astype(np.float32)),
                                  requires_grad=False)
        flax_init_(self)

    def _coeffs(self, h: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, dim) -> (B, T·frame_len) waveform."""
        coeffs = self._coeffs(self.out(x))
        frames = torch.matmul(coeffs, self.basis.to(coeffs.dtype).T)   # (B, T, 2N)
        hop, t = self.frame_len, frames.shape[1]
        return overlap_add(frames, hop)[:, hop // 2: hop // 2 + t * hop]


class IMDCTSymExpHead(_IMDCTHead):
    """Symmetric-exponential coefficients: sign(h)·(exp(min(|h|, 10)) - 1)."""

    def _coeffs(self, h: torch.Tensor) -> torch.Tensor:
        return torch.sign(h) * (torch.exp(torch.clamp(h.abs(), max=10.0)) - 1.0)


class IMDCTCosHead(_IMDCTHead):
    """exp(min(m, 10))·cos(p) from a projection of twice the frame length."""

    def __init__(self, dim: int, mdct_frame_len: int = 512):
        super().__init__(dim, mdct_frame_len, out_mult=2)

    def _coeffs(self, h: torch.Tensor) -> torch.Tensor:
        m, p = h.chunk(2, dim=-1)
        return torch.exp(torch.clamp(m, max=10.0)) * torch.cos(p)
