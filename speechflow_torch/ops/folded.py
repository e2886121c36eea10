"""Folded (space-to-depth) execution of 1-D conv stacks (counterpart of
``speechflow_tpu/ops/folded.py``).

An activation (B, T, C) is kept as

    x_f[b, s, p*C + c] = x[b, s*F + p, c]        (phase-major fold)

which in row-major order is the same memory: ``fold`` and ``unfold`` are
reshapes. A SAME, stride-1 conv (kernel k, dilation d) becomes a dense conv
of K' taps over the folded width F·C, and a strided ConvTranspose a folded
conv that emits r·F output phases; both kernels are exact host-side
scatters of the true weights (``fold_conv_kernel``,
``fold_conv_transpose_kernel``, numpy copies of the JAX package's). Zero
padding matches, so the transform is exact up to float reassociation.

``folded_conv`` runs a folded kernel, kept in flax's (K', W_in, W_out)
layout, as a dense convolution over the channels-last tensor: (B, S, W) is
NHWC with H = 1, so a channels-last ``conv2d`` reads it in place, with no
transposes and one rounding of the sum. The other formulation, K' shifted
batched products accumulated into one output, rounds the running sum once a
tap in bf16; ``python3 -m speechflow_torch.tools.folded_conv_sweep`` times the
two at the flagship head's folded shapes.

The anti-aliased snake on a folded tensor is the unfolded snake on the
unfolded view of the same memory, with the per-channel α and β (a folded
state's ``alpha_f`` is α tiled F times). So the folded entries below launch
the hand-written kernels of ``speechflow_torch.ops.anti_alias`` on that
view: the same three entries, at the same shapes, as the unfolded head.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from speechflow_torch.ops.anti_alias import (
    aa_snake_downsample,
    aa_upsample_fir,
    anti_alias_snake,
)

__all__ = ["fold", "unfold", "fold_conv_kernel", "fold_conv_transpose_kernel",
           "folded_conv", "folded_aa_upsample_fir", "folded_aa_snake_downsample",
           "folded_anti_alias_snake"]


def fold(x: torch.Tensor, f: int) -> torch.Tensor:
    """(B, T, C) -> (B, T/F, F·C), phase-major (a reshape)."""
    b, t, c = x.shape
    if t % f:
        raise ValueError(f"T={t} not divisible by fold factor {f}")
    return x.reshape(b, t // f, f * c)


def unfold(xf: torch.Tensor, c: int) -> torch.Tensor:
    """(B, S, F·C) -> (B, S·F, C), the inverse of :func:`fold`."""
    b, s, w = xf.shape
    if w % c:
        raise ValueError(f"width {w} is not a multiple of C={c}")
    return xf.reshape(b, s * (w // c), c)


def fold_conv_kernel(w: np.ndarray, f: int, dilation: int = 1
                     ) -> tp.Tuple[np.ndarray, tp.Tuple[int, int]]:
    """Fold a SAME, stride-1 conv kernel (k, C_in, C_out) for fold factor F.

    True op (XLA SAME): y[t] = sum_j w[j] · x[t + j·d - pad_left],
    pad_left = ((k-1)·d)//2. Output phase p at folded step u reads true
    offset o = p + j·d - pad_left: folded step u + o//F, phase o%F.
    Returns (w_f (K', F·C_in, F·C_out), (pad_lo, pad_hi)).
    """
    k, c_in, c_out = w.shape
    pad_left = ((k - 1) * dilation) // 2
    offs = [(p, j, p + j * dilation - pad_left) for p in range(f) for j in range(k)]
    dmin = min(o // f for _, _, o in offs)
    dmax = max(o // f for _, _, o in offs)
    w_f = np.zeros((dmax - dmin + 1, f * c_in, f * c_out), w.dtype)
    for p, j, o in offs:
        q, dlt = o % f, o // f
        w_f[dlt - dmin, q * c_in:(q + 1) * c_in, p * c_out:(p + 1) * c_out] += w[j]
    return w_f, (-dmin, dmax)


def fold_conv_transpose_kernel(w: np.ndarray, f: int, stride: int
                               ) -> tp.Tuple[np.ndarray, tp.Tuple[int, int]]:
    """Fold a SAME ConvTranspose kernel (k, C_in, C_out), stride r
    (flax's ``transpose_kernel=False``): input fold F, output fold r·F over
    the same folded steps. Tap (j, p_out) contributes iff
    (p_out + j - pad_a) % r == 0, reading true input u·F + (p_out + j - pad_a)//r.
    Returns (w_f (K'', F·C_in, r·F·C_out), (pad_lo, pad_hi)).
    """
    k, c_in, c_out = w.shape
    r = stride
    pad_len = k + r - 2
    pad_a = k - 1 if r > k - 1 else int(np.ceil(pad_len / 2))
    f_out = r * f
    offs = [(p_out, j, (p_out + j - pad_a) // r)
            for p_out in range(f_out) for j in range(k) if (p_out + j - pad_a) % r == 0]
    dmin = min(o // f for _, _, o in offs)
    dmax = max(o // f for _, _, o in offs)
    w_f = np.zeros((dmax - dmin + 1, f * c_in, f_out * c_out), w.dtype)
    for p_out, j, o in offs:
        q, dlt = o % f, o // f
        w_f[dlt - dmin, q * c_in:(q + 1) * c_in,
            p_out * c_out:(p_out + 1) * c_out] += w[j]
    return w_f, (-dmin, dmax)


# above 17 taps cuDNN's choice for a channels-last conv2d of 384 channels (bf16, H100,
# torch 2.11 with CUDA 12.8) drops to a generic kernel that is an order of magnitude
# slower (PERF.md §6; ``speechflow_torch.tools.folded_conv_sweep``): longer folded
# kernels run as chunks of at most this many taps, their outputs summed
MAX_TAPS_PER_CONV = 17


def folded_conv(xf: torch.Tensor, w_f: torch.Tensor, pad: tp.Tuple[int, int],
                bias_f: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, W_in) x (K', W_in, W_out) -> (B, S, W_out):
    y[s] = sum_k xpad[s + k] @ w_f[k] (+ bias), a channels-last conv2d."""
    s = xf.shape[1]
    xp = F.pad(xf, (0, 0, pad[0], pad[1]))
    w = w_f.to(xf.dtype)
    k = w.shape[0]
    size = -(-k // -(-k // MAX_TAPS_PER_CONV))  # balanced chunks of <= MAX_TAPS_PER_CONV
    out = None
    for c0 in range(0, k, size):
        c1 = min(k, c0 + size)
        x4 = xp[:, c0:c1 + s - 1].permute(0, 2, 1).unsqueeze(2)  # (B, W_in, 1, S+c1-c0-1)
        w4 = w[c0:c1].permute(2, 1, 0).unsqueeze(2).contiguous(
            memory_format=torch.channels_last)                     # (W_out, W_in, 1, c1-c0)
        bias = bias_f.to(xf.dtype) if bias_f is not None and out is None else None
        y = F.conv2d(x4, w4, bias).squeeze(2).permute(0, 2, 1)
        out = y if out is None else out + y
    return out


def folded_aa_upsample_fir(xf: torch.Tensor, c: int, taps: int = 12
                           ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 of the anti-aliased snake on a folded tensor: the (even, odd)
    pair, each folded like ``xf``."""
    y_even, y_odd = aa_upsample_fir(unfold(xf, c), taps)
    return y_even.view(xf.shape), y_odd.view(xf.shape)


def folded_aa_snake_downsample(y_even: torch.Tensor, y_odd: torch.Tensor,
                               alpha_f: torch.Tensor, beta_f: torch.Tensor, c: int,
                               taps: int = 12) -> torch.Tensor:
    """Snake + stage 2 on a folded stage-1 pair; ``alpha_f``/``beta_f`` are the
    per-channel log-parameters tiled F times."""
    out = aa_snake_downsample(unfold(y_even, c), unfold(y_odd, c), alpha_f[:c],
                              beta_f[:c], taps)
    return out.view(y_even.shape)


def folded_anti_alias_snake(xf: torch.Tensor, alpha_f: torch.Tensor,
                            beta_f: torch.Tensor, c: int, taps: int = 12) -> torch.Tensor:
    """The fused anti-aliased snake on a folded tensor."""
    return anti_alias_snake(unfold(xf, c), alpha_f[:c], beta_f[:c], taps).view(xf.shape)
