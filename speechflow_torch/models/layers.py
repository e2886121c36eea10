"""Layers with flax's semantics in PyTorch, channels-last.

The JAX package builds on ``nnx.Conv``, ``nnx.ConvTranspose`` and
``nnx.MultiHeadAttention``; these are their counterparts, with parameters in
PyTorch's layout (``speechflow_torch.convert`` maps flax's onto them):

- ``Conv1d``: ``nnx.Conv(..., padding="SAME")`` — XLA SAME padding,
  pad_lo = (K_eff-1)//2 with K_eff = (K-1)·dilation + 1 (even kernels put the
  extra zero on the right), optional groups; at a stride s, ceil(T/s) outputs
  with the pads XLA takes for that T.
- ``Conv2d``: a 2-D ``nnx.Conv(..., padding="SAME")`` over (B, H, W, C) with
  strides and dilation: XLA SAME gives ceil(n/stride) outputs and puts the odd
  pad on the high side (torch's ``padding="same"`` refuses a stride above 1).
- ``ConvTranspose1d``: ``nnx.ConvTranspose(..., strides=(r,), padding="SAME")``
  with flax's default ``transpose_kernel=False``, defined as
  ``lax.conv_transpose`` defines it: dilate the input by r, pad as lax pads
  SAME, and correlate with the kernel unflipped. (``nn.ConvTranspose1d`` with
  a permuted kernel is a different function.)
- ``MultiHeadAttention``: ``nnx.MultiHeadAttention`` self-attention with
  q/k/v/out projections, through ``flash_attention_fn`` (``dropout`` on the
  attention weights when ``deterministic`` is False, flax's ``dropout_rate``).

- ``RNN``: ``nnx.RNN`` over ``nnx.GRUCell`` or ``nnx.OptimizedLSTMCell``, one
  direction, from a zero carry over every step of the padded sequence (the JAX
  encoders pass no ``seq_lengths``); ``reverse`` runs from the last step and
  keeps the order. The cells keep flax's parameters: the GRU's input dense has
  a bias and its hidden dense none (so n = tanh(W_in·x + b_in + r ⊙ W_hn·h)),
  the LSTM the other way round; the recurrence runs as torch's GRU / LSTM
  (cuDNN on the GPU) with the missing bias a constant zero, in float32.

``flax_init_`` draws a module's weights from flax's default initialisers, so a
model trained from scratch starts where the JAX one does: the acoustic model,
XTTS, the prosody model, ECAPA, the vocoders and the discriminators call it at
the end of their constructors.
"""

from __future__ import annotations

import math
import typing as tp
import warnings

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.ops.attention import flash_attention_fn

__all__ = ["Conv1d", "Conv2d", "ConvTranspose1d", "MultiHeadAttention", "RNN", "RNNCell",
           "flax_init_", "layer_norm"]

# the standard deviation of a unit normal truncated to ±2 (``variance_scaling``'s
# "truncated_normal" divides by it)
_TRUNC_STD = 0.87962566103423978


def layer_norm(dim: int, affine: bool = True) -> nn.LayerNorm:
    """``nnx.LayerNorm``: eps = 1e-6 (torch's default is 1e-5)."""
    return nn.LayerNorm(dim, eps=1e-6, elementwise_affine=affine)


def _same_pads_strided(n: int, kernel_size: int, stride: int, dilation: int
                        ) -> tp.Tuple[int, int]:
    """XLA SAME along one axis of length n: ceil(n / stride) outputs."""
    k_eff = (kernel_size - 1) * dilation + 1
    total = max((-(-n // stride) - 1) * stride + k_eff - n, 0)
    return total // 2, total - total // 2


class Conv1d(nn.Conv1d):
    """(B, T, Cin) -> (B, ceil(T/stride), Cout), XLA SAME padding (at a stride
    above 1 the pads depend on T, and an odd pad goes on the high side)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int,
                 dilation: int = 1, groups: int = 1, bias: bool = True, stride: int = 1):
        super().__init__(dim_in, dim_out, kernel_size, stride=stride, dilation=dilation,
                         groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = _same_pads_strided(x.shape[1], self.kernel_size[0], self.stride[0],
                                  self.dilation[0])
        h = F.pad(x.transpose(1, 2), pads)
        return super().forward(h).transpose(1, 2)


class Conv2d(nn.Conv2d):
    """(B, H, W, Cin) -> (B, ceil(H/sh), ceil(W/sw), Cout), XLA SAME padding."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: tp.Tuple[int, int],
                 stride: tp.Tuple[int, int] = (1, 1), dilation: tp.Tuple[int, int] = (1, 1)):
        super().__init__(dim_in, dim_out, tuple(kernel_size), stride=tuple(stride),
                         dilation=tuple(dilation))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        (ph0, ph1), (pw0, pw1) = (
            _same_pads_strided(n, k, s, d) for n, k, s, d in
            zip(h.shape[2:], self.kernel_size, self.stride, self.dilation))
        h = F.pad(h, (pw0, pw1, ph0, ph1))
        return super().forward(h).permute(0, 2, 3, 1)


class ConvTranspose1d(nn.Module):
    """(B, T, Cin) -> (B, T·r, Cout): ``lax.conv_transpose`` with SAME padding
    and an unflipped kernel. ``weight`` is (Cout, Cin, K) as a correlation
    kernel (flax's (K, Cin, Cout) permuted, not flipped)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int, stride: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in, kernel_size))
        self.bias = nn.Parameter(torch.zeros(dim_out))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.stride = stride
        k, s = kernel_size, stride
        # lax._conv_transpose_padding for "SAME"
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else (pad_len + 1) // 2
        self.pads = (pad_a, pad_len - pad_a)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        s = self.stride
        xd = x.new_zeros(b, c, (t - 1) * s + 1)
        xd[:, :, ::s] = x.transpose(1, 2)
        h = F.pad(xd, self.pads)
        return F.conv1d(h, self.weight, self.bias).transpose(1, 2)


class MultiHeadAttention(nn.Module):
    """Self-attention with flax's projections: (B, T, D) -> (B, T, D)."""

    def __init__(self, dim: int, n_heads: int, dropout: float = 0.0):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"dim {dim} not divisible by {n_heads} heads")
        self.dropout = dropout
        self.n_heads = n_heads
        self.head_dim = dim // n_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, valid: tp.Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        b, t, _ = x.shape
        shape = (b, t, self.n_heads, self.head_dim)
        q = self.query(x).view(shape)
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        o = flash_attention_fn(q, k, v, valid, dropout_rate=self.dropout,
                               deterministic=deterministic)
        return self.out(o.reshape(b, t, -1))


class RNNCell(nn.Module):
    """The parameters of ``nnx.GRUCell`` (``dense_i`` with a bias, ``dense_h``
    without) or ``nnx.OptimizedLSTMCell`` (the other way round), gates in
    flax's order (r, z, n and i, f, g, o, torch's too)."""

    orthogonal_init = ("dense_h",)

    def __init__(self, kind: str, dim_in: int, hidden: int):
        super().__init__()
        gates = {"gru": 3, "lstm": 4}[kind]
        self.dense_i = nn.Linear(dim_in, gates * hidden, bias=kind == "gru")
        self.dense_h = nn.Linear(hidden, gates * hidden, bias=kind == "lstm")


class RNN(nn.Module):
    """(B, T, Din) -> (B, T, hidden): ``nnx.RNN(cell, reverse=..., keep_order=True)``
    with no ``seq_lengths``."""

    def __init__(self, kind: str, dim_in: int, hidden: int, reverse: bool = False):
        super().__init__()
        self.kind = kind
        self.hidden = hidden
        self.reverse = reverse
        self.cell = RNNCell(kind, dim_in, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        di, dh = self.cell.dense_i, self.cell.dense_h
        with torch.autocast(x.device.type, enabled=False):
            x = x.float()
            if self.reverse:
                x = x.flip(1)
            zero = torch.zeros(dh.weight.shape[0], device=x.device, dtype=x.dtype)
            h0 = x.new_zeros(1, x.shape[0], self.hidden)
            weights = [di.weight.float(), dh.weight.float(),
                       zero if di.bias is None else di.bias.float(),
                       zero if dh.bias is None else dh.bias.float()]
            with warnings.catch_warnings():
                # cuDNN would like the four weights in one buffer; they stay the
                # module's own parameters
                warnings.simplefilter("ignore", UserWarning)
                args = (weights, True, 1, 0.0, torch.is_grad_enabled(), False, True)
                if self.kind == "gru":
                    out = torch._VF.gru(x, h0, *args)[0]
                else:
                    out = torch._VF.lstm(x, (h0, h0), *args)[0]
        return out.flip(1) if self.reverse else out


def flax_init_(module: nn.Module) -> nn.Module:
    """Flax's default initialisers over every layer of ``module``, in place, from
    torch's global generator: the kernels of ``nnx.Linear``, ``nnx.Conv`` and
    ``nnx.ConvTranspose`` lecun-normal (std 1/sqrt(fan_in), fan_in = all but the
    output axis, truncated at two of the normal's deviations), their biases zero;
    ``nnx.Embed`` normal with std 1/sqrt(features); ``nnx.LayerNorm`` scale 1,
    bias 0. The layers a module names in its ``zero_init`` start at zero, as flax's
    ``zeros_init`` kernels with zero biases; those in its ``orthogonal_init`` get
    an orthogonal kernel (the recurrent kernels, flax's ``orthogonal()``). Other
    parameters keep their constructed values."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, ConvTranspose1d)):
                std = math.prod(m.weight.shape[1:]) ** -0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, std=m.embedding_dim ** -0.5)
            elif isinstance(m, nn.LayerNorm) and m.elementwise_affine:
                m.weight.fill_(1.0)
                if m.bias is not None:
                    m.bias.zero_()
        for m in module.modules():
            for name in getattr(m, "zero_init", ()):
                for p in getattr(m, name).parameters():
                    p.zero_()
            for name in getattr(m, "orthogonal_init", ()):
                nn.init.orthogonal_(getattr(m, name).weight)
    return module
