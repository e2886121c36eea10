"""Fused attention (counterpart of ``speechflow_tpu/ops/attention.py``).

``fused_attention`` is the wrapper of the hand-written CUDA kernel
``csrc/attention.cu``, which replaces the TPU kernel ``_fused_attn_kernel``
(``_fused_attn_fwd_impl``). On a CPU tensor it runs ``attention_reference``,
the plain PyTorch version of the same function; on a CUDA tensor it launches
the kernel or raises.

``flash_attention_fn`` keeps the JAX wrapper's contract: q/k/v are
(B, T, H, dh), padded keys are masked out of every softmax row and padded
query rows come out as zeros (flax's CPU fallback leaves a uniform average
there instead; compare valid rows only).
"""

from __future__ import annotations

import ctypes
import math
import typing as tp

import torch

from speechflow_torch.ops import _build

__all__ = ["attention_reference", "fused_attention", "flash_attention_fn"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Plain version: einsum, masked softmax, einsum; f32 logits and sums.

    q/k/v: (B, T, H, dh); valid: (B, T) bool or 0/1. Returns (B, T, H, dh) in
    q's dtype with padded query rows zeroed.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    keep = valid.to(torch.bool)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = logits.masked_fill(~keep[:, None, None, :], -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return (out * keep[:, :, None, None].float()).to(q.dtype)


def _launch(q, k, v, valid):
    if not (q.shape == k.shape == v.shape) or q.ndim != 4:
        raise ValueError(f"q/k/v must share a (B, T, H, dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention takes float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    b, t, h, dh = q.shape
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} > {MAX_HEAD_DIM}")
    if valid.shape != (b, t):
        raise ValueError(f"valid must be (B, T) = {(b, t)}, got {tuple(valid.shape)}")
    devs = {x.device for x in (q, k, v, valid)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    valid = valid.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    fn = _build.function("attention", "sf_attention_fwd",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
             out.data_ptr(), b, t, h, dh, _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "sf_attention_fwd")
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ/√dh with padded keys masked) v, padded query rows zeroed.

    q/k/v: (B, T, H, dh) float32 or bfloat16; valid: (B, T). CPU tensors run
    the plain version; CUDA tensors launch the kernel (counted in
    ``fused_attention.launches``).
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, valid)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda, not {q.device}")
    out = _launch(q, k, v, valid)
    fused_attention.launches += 1
    return out


fused_attention.launches = 0


def flash_attention_fn(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                       mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """q/k/v (B, T, H, dh) -> (B, T, H, dh).

    ``mask`` is the blocks' 4-D mask ``valid[:,None,None,:] & valid[:,None,:,None]``
    (the key validity is recovered as ``mask[:, 0, 0, :]``; row 0 is always
    valid since lengths >= 1), a (B, T) validity vector, or None (all valid).
    """
    b, t = query.shape[:2]
    if mask is None:
        valid = torch.ones((b, t), dtype=torch.bool, device=query.device)
    elif mask.ndim == 4:
        valid = mask[:, 0, 0, :]
    elif mask.ndim == 2:
        valid = mask
    else:
        raise ValueError(f"mask must be 4-D or (B, T), got {tuple(mask.shape)}")
    return fused_attention(query, key, value, valid)
