"""Plain PyTorch primitives of the benchmark's reference models.

Nothing here imports the program: each function is the plain form of what the
configuration states (flax's SAME convolutions, LayerNorm at eps 1e-6, the
tanh GELU, half-split RoPE, masked softmax attention, BigVGAN's anti-aliased
snake as a Kaiser-sinc FIR pair around the snake-beta), written out again.

``Precision`` says how a reference computes. ``Precision.reference()`` is
float32 with TF32 off (set by the caller on ``torch.backends``). The control
``Precision.control()`` computes in bfloat16 and rounds both operands of every
matrix product and convolution (and q, k, v of attention) to float8 e4m3 with
one scale a tensor, as fp8 inference does: the step below the configuration's
bfloat16 that a later change could be tempted to take.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # float8 e4m3fn


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float32
    fp8: bool = False

    @staticmethod
    def reference() -> "Precision":
        return Precision(torch.float32, False)

    @staticmethod
    def control() -> "Precision":
        return Precision(torch.bfloat16, True)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product in this precision. The float8 rounding passes
        gradients straight through, as fp8 training's does."""
        x = x.to(self.dtype)
        if not self.fp8:
            return x
        amax = x.detach().abs().amax().float().clamp(min=1e-12)
        scale = FP8_MAX / amax
        rounded = ((x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale)
        return x + (rounded.to(self.dtype) - x).detach()


def linear(x: torch.Tensor, w: torch.Tensor, b: tp.Optional[torch.Tensor],
           prec: Precision) -> torch.Tensor:
    return F.linear(prec.q(x), prec.q(w), None if b is None else b.to(prec.dtype))


def same_pads(k: int, dilation: int = 1) -> tp.Tuple[int, int]:
    """XLA SAME at stride 1: the extra zero of an even kernel on the right."""
    k_eff = (k - 1) * dilation + 1
    return (k_eff - 1) // 2, k_eff - 1 - (k_eff - 1) // 2


def conv1d(x: torch.Tensor, w: torch.Tensor, b: tp.Optional[torch.Tensor], prec: Precision,
           dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """(B, T, Cin) -> (B, T, Cout), SAME, cross-correlation; w is (Cout, Cin/groups, K)."""
    h = F.pad(prec.q(x).transpose(1, 2), same_pads(w.shape[-1], dilation))
    out = F.conv1d(h, prec.q(w), None if b is None else b.to(prec.dtype),
                   dilation=dilation, groups=groups)
    return out.transpose(1, 2)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
                     prec: Precision) -> torch.Tensor:
    """``lax.conv_transpose`` with SAME padding and an unflipped (Cout, Cin, K) kernel:
    the input dilated by ``stride``, padded as lax pads SAME, then correlated."""
    bsz, t, c = x.shape
    k = w.shape[-1]
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else (pad_len + 1) // 2
    xd = x.new_zeros(bsz, c, (t - 1) * stride + 1, dtype=prec.dtype)
    xd[:, :, ::stride] = prec.q(x).transpose(1, 2)
    h = F.pad(xd, (pad_a, pad_len - pad_a))
    return F.conv1d(h, prec.q(w), b.to(prec.dtype)).transpose(1, 2)


def layer_norm(x: torch.Tensor, w: tp.Optional[torch.Tensor], b: tp.Optional[torch.Tensor],
               prec: Precision) -> torch.Tensor:
    d = x.shape[-1]
    out = F.layer_norm(x.float(), (d,), None if w is None else w.float(),
                       None if b is None else b.float(), eps=1e-6)
    return out.to(prec.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def sinusoidal(positions: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    args = positions[..., None].float() * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def rope(x: torch.Tensor, max_period: float = 10000.0) -> torch.Tensor:
    """Half-split rotary embedding over the last two axes (T, D), in float32."""
    t, d = x.shape[-2], x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:2 * half]
    parts = [x1 * cos - x2 * sin, x1 * sin + x2 * cos]
    if d % 2:
        parts.append(xf[..., -1:])
    return torch.cat(parts, dim=-1).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    """(B, T, H, dh) each; padded keys masked, padded query rows zero; f32 softmax."""
    q, k, v = prec.q(q), prec.q(k), prec.q(v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = logits.masked_fill(~valid[:, None, None, :], -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(prec.dtype).float(), v.float())
    return (out * valid[:, :, None, None]).to(prec.dtype)


def seq_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


# -- BigVGAN's anti-aliased snake ------------------------------------------------


@functools.lru_cache(maxsize=None)
def kaiser_sinc(taps: int = 12, cutoff: float = 0.25, half_width: float = 0.15) -> np.ndarray:
    """Kaiser-windowed sinc low-pass (BigVGAN's ``kaiser_sinc_filter1d``), unit sum."""
    even = taps % 2 == 0
    half = taps // 2
    delta_f = 4 * half_width
    a = 2.285 * (half - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    t = np.arange(-half, half) + 0.5 if even else np.arange(taps) - half
    filt = 2 * cutoff * np.sinc(2 * cutoff * t) * np.kaiser(taps, beta)
    return (filt / filt.sum()).astype(np.float32)


def _fir(v: torch.Tensor, taps: tp.Dict[int, float]) -> torch.Tensor:
    """out[:, i] = sum over shifts s of w_s · v[:, i + s] along axis 1 of (B, T, C),
    zeros outside [0, T): one depthwise correlation."""
    lo, hi = min(taps), max(taps)
    kernel = torch.zeros(hi - lo + 1, dtype=v.dtype, device=v.device)
    for s, w in taps.items():
        kernel[s - lo] += w
    c = v.shape[-1]
    h = F.pad(v.transpose(1, 2), (max(-lo, 0), max(hi, 0)))
    out = F.conv1d(h, kernel.expand(c, 1, -1).contiguous(), groups=c)
    t0 = max(lo, 0)
    return out[:, :, t0: t0 + v.shape[1]].transpose(1, 2)


def anti_alias_snake(x: torch.Tensor, log_alpha: torch.Tensor, log_beta: torch.Tensor,
                     taps: int = 12) -> torch.Tensor:
    """(B, T, C): 2x zero-stuffed upsample, the FIR (gain 2), snake-beta
    y + sin(αy)²/β with α = exp(log α), β = exp(log β), the FIR again, 2x
    decimation; XLA SAME anchoring of the filter (left pad (K-1)//2). The
    polyphase form: stage 1 gives the even and odd output phases at the input's
    rate, stage 2 sums both phases' snakes. In float32 (float64 for a float64
    input); out in x's dtype."""
    filt = kaiser_sinc(taps)
    p = (taps - 1) // 2
    wide = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(wide)
    y_even = _fir(xf, {(k - p) // 2: 2.0 * float(filt[k]) for k in range(taps)
                       if (k - p) % 2 == 0})
    y_odd = _fir(xf, {(k - p + 1) // 2: 2.0 * float(filt[k]) for k in range(taps)
                      if (k - p) % 2 != 0})
    a = torch.exp(log_alpha.to(wide))
    inv_b = 1.0 / (torch.exp(log_beta.to(wide)) + 1e-9)
    z_even = y_even + inv_b * torch.sin(a * y_even) ** 2
    z_odd = y_odd + inv_b * torch.sin(a * y_odd) ** 2
    out = _fir(z_even, {(k - p) // 2: float(filt[k]) for k in range(taps) if (k - p) % 2 == 0})
    out = out + _fir(z_odd, {(k - p - 1) // 2: float(filt[k]) for k in range(taps)
                             if (k - p) % 2 != 0})
    return out.to(x.dtype)
