"""1-D signal ops on tensors (counterpart of ``speechflow_tpu/ops/signal.py``):
pre- and de-emphasis, frame energy, spectral flatness, the mu-law codec, RMS
loudness normalisation, dithering (from a ``torch.Generator`` where JAX takes
a key), moving-average smoothing, quantile clipping, range normalisation and
the depthwise convolution."""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F

__all__ = [
    "preemphasis", "deemphasis", "energy", "spectral_flatness",
    "mu_law_encode", "mu_law_decode", "rms_normalize", "dither",
    "smooth_1d", "clip_quantile", "range_normalize", "depthwise_conv1d",
]


def depthwise_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                     bias: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-channel 1-D convolution, SAME padding, cross-correlation.

    ``x``: (B, T, C); ``kernel``: (C, 1, K) (``nn.Conv1d``'s depthwise layout).
    Numerically the JAX ``depthwise_conv1d`` (and ``nnx.Conv`` with
    ``feature_group_count=C``): pad_lo = (K-1)//2, pad_hi = K-1-pad_lo. The
    JAX package writes it as K shifted adds because grouped convs lower badly
    on a TPU; here it is one grouped ``conv1d``.
    """
    k = kernel.shape[-1]
    pad_lo = (k - 1) // 2
    h = F.pad(x.transpose(1, 2), (pad_lo, k - 1 - pad_lo))
    return F.conv1d(h, kernel, bias, groups=x.shape[-1]).transpose(1, 2)


def preemphasis(x: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """y[t] = x[t] - coeff·x[t-1] along the last axis (y[0] = x[0])."""
    return torch.cat([x[..., :1], x[..., 1:] - coeff * x[..., :-1]], dim=-1)


def deemphasis(x: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """The inverse of ``preemphasis``: y[t] = x[t] + coeff·y[t-1] along the last
    axis. In float64, in blocks of L samples: inside a block the recursion from a
    zero state is ``coeff^j · cumsum(x[s] / coeff^s)`` (L small enough that
    coeff^-L stays finite), then each block adds its predecessor's last value
    times coeff^(j+1), one block after another."""
    if coeff == 0.0:
        return x.clone()
    t = x.shape[-1]
    block = int(max(1, min(256, 300 // max(1.0, -math.log10(abs(coeff))))))
    n = -(-t // block)
    flat = F.pad(x.reshape(-1, t).double(), (0, n * block - t)).view(-1, n, block)
    powers = coeff ** torch.arange(block, dtype=torch.float64, device=x.device)
    local = torch.cumsum(flat / powers, dim=-1) * powers
    carry_gain = powers * coeff
    out = torch.empty_like(local)
    carry = local.new_zeros(local.shape[0], 1)
    for k in range(n):
        out[:, k] = local[:, k] + carry * carry_gain
        carry = out[:, k, -1:]
    return out.reshape(-1, n * block)[:, :t].reshape(x.shape).to(x.dtype)


def energy(mag: torch.Tensor) -> torch.Tensor:
    """Each frame's L2 norm over frequency."""
    return torch.linalg.vector_norm(mag, dim=-1)


def spectral_flatness(mag: torch.Tensor, power: float = 2.0, amin: float = 1e-10
                      ) -> torch.Tensor:
    """``1 - clip(100 · flatness, 0, 0.99)`` of (..., T, bins) magnitudes, the
    flatness the geometric over the arithmetic mean of the power spectrum."""
    s = torch.clamp(mag, min=amin) ** power
    flat = torch.exp(torch.log(s).mean(-1)) / s.mean(-1)
    return 1.0 - torch.clamp(flat * 100.0, 0.0, 0.99)


def mu_law_encode(x: torch.Tensor, mu: int = 255) -> torch.Tensor:
    x = torch.clamp(x, -1.0, 1.0)
    return torch.sign(x) * torch.log1p(mu * x.abs()) / math.log1p(float(mu))


def mu_law_decode(y: torch.Tensor, mu: int = 255) -> torch.Tensor:
    return torch.sign(y) * ((1.0 + mu) ** y.abs() - 1.0) / mu


def rms_normalize(x: torch.Tensor, target_dbfs: float = -23.0, eps: float = 1e-9
                  ) -> torch.Tensor:
    """Each row (last axis) scaled to an RMS of ``target_dbfs`` dBFS."""
    rms = torch.sqrt((x * x).mean(-1, keepdim=True) + eps)
    return x * (10.0 ** (target_dbfs / 20.0) / torch.clamp(rms, min=eps))


def dither(x: torch.Tensor, generator: tp.Optional[torch.Generator] = None,
           amount: float = 1e-5) -> torch.Tensor:
    """``x`` plus ``amount`` times standard normal noise drawn from ``generator``."""
    noise = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    return x + amount * noise


def smooth_1d(x: torch.Tensor, win: int = 5) -> torch.Tensor:
    """A ``win``-wide moving average along the last axis, edges repeated."""
    pad = win // 2
    flat = x.reshape(-1, 1, x.shape[-1])
    xp = F.pad(flat, (pad, pad), mode="replicate")
    kernel = torch.full((1, 1, win), 1.0 / win, dtype=x.dtype, device=x.device)
    out = F.conv1d(xp, kernel)
    return out.reshape(x.shape[:-1] + (out.shape[-1],))[..., : x.shape[-1]]


def clip_quantile(x: torch.Tensor, q_low: float = 0.01, q_high: float = 0.99) -> torch.Tensor:
    """``x`` clipped to its own [q_low, q_high] quantiles along the last axis
    (linear interpolation, as numpy's and JAX's default)."""
    lo = torch.quantile(x, q_low, dim=-1, keepdim=True)
    hi = torch.quantile(x, q_high, dim=-1, keepdim=True)
    return torch.minimum(torch.maximum(x, lo), hi)


def range_normalize(x: torch.Tensor, minimum, maximum, eps: float = 1e-8) -> torch.Tensor:
    """``(x - minimum) / max(maximum - minimum, eps)``: [0, 1] over a (per-speaker) range."""
    span = torch.as_tensor(maximum, dtype=x.dtype, device=x.device) - minimum
    return (x - minimum) / torch.clamp(span, min=eps)
