"""1-D signal ops (counterpart of ``speechflow_tpu/ops/signal.py``; the slice
needs only the depthwise convolution)."""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

__all__ = ["depthwise_conv1d"]


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
