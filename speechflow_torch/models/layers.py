"""Layers with flax's semantics in PyTorch, channels-last.

The JAX package builds on ``nnx.Conv``, ``nnx.ConvTranspose`` and
``nnx.MultiHeadAttention``; these are their counterparts, with parameters in
PyTorch's layout (``speechflow_torch.convert`` maps flax's onto them):

- ``Conv1d``: ``nnx.Conv(..., padding="SAME")`` — XLA SAME padding,
  pad_lo = (K_eff-1)//2 with K_eff = (K-1)·dilation + 1 (even kernels put the
  extra zero on the right), optional groups.
- ``ConvTranspose1d``: ``nnx.ConvTranspose(..., strides=(r,), padding="SAME")``
  with flax's default ``transpose_kernel=False``, defined as
  ``lax.conv_transpose`` defines it: dilate the input by r, pad as lax pads
  SAME, and correlate with the kernel unflipped. (``nn.ConvTranspose1d`` with
  a permuted kernel is a different function.)
- ``MultiHeadAttention``: ``nnx.MultiHeadAttention`` self-attention with
  q/k/v/out projections, through ``flash_attention_fn``.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.ops.attention import flash_attention_fn

__all__ = ["Conv1d", "ConvTranspose1d", "MultiHeadAttention", "layer_norm"]


def layer_norm(dim: int, affine: bool = True) -> nn.LayerNorm:
    """``nnx.LayerNorm``: eps = 1e-6 (torch's default is 1e-5)."""
    return nn.LayerNorm(dim, eps=1e-6, elementwise_affine=affine)


def _same_pads(kernel_size: int, dilation: int = 1) -> tp.Tuple[int, int]:
    total = (kernel_size - 1) * dilation
    return total // 2, total - total // 2


class Conv1d(nn.Conv1d):
    """(B, T, Cin) -> (B, T, Cout), stride 1, XLA SAME padding."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int,
                 dilation: int = 1, groups: int = 1, bias: bool = True):
        super().__init__(dim_in, dim_out, kernel_size, dilation=dilation,
                         groups=groups, bias=bias)
        self.pads = _same_pads(kernel_size, dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.pad(x.transpose(1, 2), self.pads)
        return super().forward(h).transpose(1, 2)


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

    def __init__(self, dim: int, n_heads: int):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"dim {dim} not divisible by {n_heads} heads")
        self.n_heads = n_heads
        self.head_dim = dim // n_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                valid: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        shape = (b, t, self.n_heads, self.head_dim)
        q = self.query(x).view(shape)
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        o = flash_attention_fn(q, k, v, valid)
        return self.out(o.reshape(b, t, -1))
