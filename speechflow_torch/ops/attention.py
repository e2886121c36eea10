"""Fused attention (counterpart of ``speechflow_tpu/ops/attention.py``).

``fused_attention`` is the wrapper of the hand-written CUDA kernel
``csrc/attention.cu``, which replaces the TPU kernel ``_fused_attn_kernel``
(``_fused_attn_fwd_impl``). On a CPU tensor it runs ``attention_reference``,
the plain PyTorch version of the same function; on a CUDA tensor it launches
the kernel or raises.

Two kernels of that file serve a CUDA tensor, and nothing else does:
bfloat16 at dh <= 128 goes to the persistent ``wgmma`` + TMA kernel; float32
at any dh <= 256, and bfloat16 at 128 < dh <= 256 (the XTTS prompt encoder),
to a flash forward on the tensor cores in TF32 (``mma.sync``) that splits
each f32 operand into two TF32 parts and takes three products, at f32
accuracy. Both read the key validity in place as bytes with its strides, so
a bool view such as ``mask[:, 0, 0, :]`` costs no cast and no copy, and a
call launches one device kernel.

``flash_attention_fn`` keeps the JAX wrapper's contract: q/k/v are
(B, T, H, dh), padded keys are masked out of every softmax row and padded
query rows come out as zeros (flax's CPU fallback leaves a uniform average
there instead; compare valid rows only). As the JAX wrapper's ``_flash_ok``
does, it sends only the deterministic call to the kernel: a training call
(``deterministic=False``) takes the plain version, with dropout on the
attention weights, and gets autograd's backward.

Gradients. On a CUDA tensor ``fused_attention`` is a ``torch.autograd.Function``
(the counterpart of the ``jax.custom_vjp`` ``_fused_attention``): the kernel
is the forward, and the backward is ``fused_attention_vjp``, JAX's
``_fused_attention_bwd`` in PyTorch ops (the softmax recomputed in f32 from
q, k and the key validity; no backward kernel, as JAX has none). The kernel
zeroes padded query rows itself, where JAX zeroes them after
``_fused_attention`` (``flash_attention_fn``), so the VJP first zeroes the
cotangent there: the same function, the same gradient. This is how a
deterministic call under autograd trains, as the XTTS prompt encoder's
blocks do.
"""

from __future__ import annotations

import ctypes
import math
import typing as tp

import torch

from speechflow_torch.ops import _build
from speechflow_torch.utils.profiler import span

__all__ = ["attention_reference", "fused_attention", "fused_attention_vjp",
           "flash_attention_fn"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
WGMMA_MAX_HEAD_DIM = 128  # above it, bf16 takes the TF32 kernel (no TMA rules)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid: torch.Tensor, dropout_rate: float = 0.0) -> torch.Tensor:
    """Plain version: einsum, masked softmax, einsum; f32 logits and sums.

    q/k/v: (B, T, H, dh); valid: (B, T) bool or 0/1. Returns (B, T, H, dh) in
    q's dtype with padded query rows zeroed. ``dropout_rate`` > 0 drops
    attention weights with one (T, T) mask shared by the batch and the heads,
    scaling the kept ones by 1 / (1 - rate), as flax's ``broadcast_dropout``.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    keep = valid.to(torch.bool)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = logits.masked_fill(~keep[:, None, None, :], -1e30)
    w = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0:
        t_q, t_k = w.shape[-2:]
        kept = torch.rand((1, 1, t_q, t_k), device=w.device) >= dropout_rate
        w = w * kept / (1.0 - dropout_rate)
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
    tma = q.dtype == torch.bfloat16 and dh <= WGMMA_MAX_HEAD_DIM
    if tma and dh % 8:
        raise ValueError(f"bf16 head dim must be a multiple of 8 (TMA's 16-byte "
                         f"strides), got {dh}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if tma and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("bf16 q/k/v must start on 16-byte aligned addresses (TMA)")
    if valid.dtype != torch.bool:  # the kernels read bytes: 0 is padded
        valid = valid != 0
    out = torch.empty_like(q)
    fn = _build.function("attention", "sf_attention_fwd",
                         [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
                         + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), valid.stride(0),
             valid.stride(1), out.data_ptr(), b, t, h, dh, _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "sf_attention_fwd")
    return out


def fused_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid: torch.Tensor, g: torch.Tensor
                        ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``fused_attention`` at cotangent ``g``, each in its input's
    dtype: JAX's ``_fused_attention_bwd`` in PyTorch ops, with ``g`` zeroed at
    padded query rows first (the forward wrote zeros there). The softmax
    w is recomputed in f32; dv = wᵀg, dw = g vᵀ, dlog = w·(dw − Σ dw·w),
    dq = dlog k/√dh, dk = dlogᵀ q/√dh. The validity gets no gradient.
    Shapes as ``fused_attention``'s."""
    keep = valid.to(torch.bool)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    w = torch.softmax(logits.masked_fill(~keep[:, None, None, :], -1e30), dim=-1)
    gf = g.float() * keep[:, :, None, None]
    dv = torch.einsum("bhqk,bqhd->bkhd", w, gf)
    dw = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    dlog = w * (dw - (dw * w).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", dlog, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dlog, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FusedAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, valid):
        ctx.save_for_backward(q, k, v, valid)
        with span("op.attention"):
            out = _launch(q, k, v, valid)
        fused_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        with span("op.attention.vjp"):
            return (*fused_attention_vjp(*ctx.saved_tensors, g), None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ/√dh with padded keys masked) v, padded query rows zeroed.

    q/k/v: (B, T, H, dh) float32 or bfloat16, dh <= 256 (bf16 at dh <= 128:
    dh a multiple of 8 and 16-byte aligned data, else ``ValueError``);
    valid: (B, T), bool (read in place, any strides) or 0/1 (compared with 0
    first). CPU tensors run the plain version under PyTorch's autograd; CUDA
    tensors launch the kernel (counted in ``fused_attention.launches``), with
    ``fused_attention_vjp`` as the backward.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, valid)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda, not {q.device}")
    return _FusedAttentionFn.apply(q, k, v, valid)


fused_attention.launches = 0


def flash_attention_fn(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                       mask: tp.Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
                       deterministic: bool = True) -> torch.Tensor:
    """q/k/v (B, T, H, dh) -> (B, T, H, dh).

    ``mask`` is the blocks' 4-D mask ``valid[:,None,None,:] & valid[:,None,:,None]``
    (the key validity is recovered as ``mask[:, 0, 0, :]``; row 0 is always
    valid since lengths >= 1), a (B, T) validity vector, or None (all valid).
    ``deterministic=False`` (training) runs ``attention_reference`` with
    ``dropout_rate`` on the weights; ``deterministic=True`` runs
    ``fused_attention`` (the kernel on a CUDA tensor).
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
    if not deterministic:
        return attention_reference(query, key, value, valid, dropout_rate)
    return fused_attention(query, key, value, valid)
