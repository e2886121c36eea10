"""Fused attention of the port against the JAX package (f32, CPU).

On the CPU the wrapper runs its plain version; it is held against the TPU
kernel run in the Pallas interpreter and against ``flash_attention_fn``
forced onto that interpreter. The CUDA kernel itself is held against the
plain version in ``test_torch_cuda_kernels.py``, on the GPU.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechflow_torch.ops import attention as A
from tests.torch_parity import n, t

torch.set_num_threads(1)
TOL = 2e-5  # the TPU kernel's own test tolerance (tests/test_pallas_kernels.py)


def _qkv(rng, *shape):
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t_len,dh", [(128, 64), (100, 16), (72, 128), (112, 256), (17, 200)])
def test_plain_matches_pallas_kernel(rng, t_len, dh):
    from speechflow_tpu.ops.attention import _fused_attn_fwd_impl

    bh = 3
    q, k, v = _qkv(rng, bh, t_len, dh)
    lens = np.array([t_len, t_len - 29, 1])
    valid = (np.arange(t_len)[None] < lens[:, None]).astype(np.float32)
    ref = n(_fused_attn_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(valid), interpret=True))
    # the port's layout is (B, T, H, dh): one head per JAX (batch*head) row
    out = n(A.fused_attention(t(q)[:, :, None], t(k)[:, :, None], t(v)[:, :, None],
                              t(valid)))[:, :, 0]
    m = valid[..., None].astype(bool)
    np.testing.assert_allclose(out * m, ref * m, atol=TOL, rtol=TOL)
    assert np.abs(out[~m[..., 0]]).max() == 0.0  # padded query rows are zero


def test_padded_keys_do_not_reach_valid_rows(rng):
    """The semantics that let the CUDA kernel skip all-padded key tiles: with the
    K/V rows of padded keys replaced by 1e4-scale noise, in a mask with holes (a
    whole 128-key tile, a ragged stretch, a ragged end), every valid row comes out
    bit for bit as before, in the port and in the TPU kernel (Pallas interpreter),
    and the two agree."""
    from speechflow_tpu.ops.attention import _fused_attn_fwd_impl

    bh, t_len, dh = 3, 384, 16
    q, k, v = _qkv(rng, bh, t_len, dh)
    valid = np.ones((bh, t_len), np.float32)
    valid[0, 128:256] = 0.0
    valid[1, 40:77] = 0.0
    valid[1, 300:] = 0.0
    valid[2, 1:] = 0.0
    pad = valid == 0
    noisy_k, noisy_v = k.copy(), v.copy()
    noisy_k[pad] = 1e4 * rng.normal(size=(pad.sum(), dh))
    noisy_v[pad] = 1e4 * rng.normal(size=(pad.sum(), dh))

    def port(kk, vv):
        return n(A.fused_attention(t(q)[:, :, None], t(kk)[:, :, None], t(vv)[:, :, None],
                                   t(valid)))[:, :, 0]

    def tpu(kk, vv):
        return n(_fused_attn_fwd_impl(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv),
                                      jnp.asarray(valid), interpret=True))

    keep = ~pad
    out, out_noisy = port(k, v), port(noisy_k, noisy_v)
    ref, ref_noisy = tpu(k, v), tpu(noisy_k, noisy_v)
    np.testing.assert_array_equal(out_noisy[keep], out[keep])
    np.testing.assert_array_equal(ref_noisy[keep], ref[keep])
    np.testing.assert_allclose(out_noisy[keep], ref_noisy[keep], atol=TOL, rtol=TOL)
    assert np.abs(out_noisy[pad]).max() == 0.0


def test_wrapper_matches_jax_flash_attention_fn(rng, monkeypatch):
    """Mask recovery from the blocks' 4-D mask, head handling and padded-query
    zeroing, against the JAX wrapper forced onto the Pallas interpreter."""
    from speechflow_tpu.ops import attention as JA

    monkeypatch.setattr(JA, "_flash_ok", lambda *a, **k: True)
    monkeypatch.setattr(JA, "_fused_attn_fwd_impl",
                        functools.partial(JA._fused_attn_fwd_impl, interpret=True))
    b, t_len, h, dh = 2, 128, 2, 16
    q, k, v = _qkv(rng, b, t_len, h, dh)
    valid = np.arange(t_len)[None, :] < np.array([128, 70])[:, None]
    mask = valid[:, None, None, :] & valid[:, None, :, None]
    ref = n(JA.flash_attention_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  mask=jnp.asarray(mask), deterministic=True))
    out4 = n(A.flash_attention_fn(t(q), t(k), t(v), mask=t(mask)))
    out2 = n(A.flash_attention_fn(t(q), t(k), t(v), mask=t(valid)))
    np.testing.assert_allclose(out4, ref, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(out2, out4)
    assert np.abs(out4[~valid]).max() == 0.0


def test_wrapper_has_no_fallback_off_the_cpu():
    q = torch.empty(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError):
        A.fused_attention(q, q, q, torch.ones(1, 4, device="meta"))
    assert A.fused_attention.launches == 0



def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` and the CUDA kernel's split do: add half of the 13 dropped
    bits to the magnitude, clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 given as a TF32 operand: its top 19 bits."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b as the tensor cores take it in TF32 with f32 sums: one product of the
    rounded operands, or three of their splits as the CUDA kernel takes them (hi =
    tf32(x), lo = x - hi read truncated; hi*hi + hi*lo + lo*hi). A TF32 product is
    exact in f32, so a f32 matmul of the parts models it."""
    ah, bh = _tf32(a), _tf32(b)
    if products == 1:
        return ah @ bh
    al, bl = _tf32_truncated(a - ah), _tf32_truncated(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tf32_attention(q, k, v, valid, products: int) -> torch.Tensor:
    """The CUDA kernel's f32 arithmetic on the CPU: logits and P V through
    ``_tf32_matmul``, the masked softmax in f32. q/k/v (BH, T, dh), valid (BH, T)."""
    keep = valid.bool()
    s = _tf32_matmul(q, k.transpose(1, 2), products) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~keep[:, None, :], -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = _tf32_matmul(p, v, products) / p.sum(-1, keepdim=True)
    return out * keep[..., None]


@pytest.mark.parametrize("t_len,dh", [(112, 256), (72, 128)])
def test_three_tf32_products_reach_f32_accuracy(rng, t_len, dh):
    """The numeric design of the f32 CUDA kernel, which runs its products on the tensor
    cores in TF32: with each operand split into two TF32 parts and three products, the
    attention agrees with the TPU kernel (Pallas interpreter) within the card's f32
    tolerance of 5e-5; with one TF32 product it does not."""
    from speechflow_tpu.ops.attention import _fused_attn_fwd_impl

    bh = 4
    q, k, v = _qkv(rng, bh, t_len, dh)
    lens = np.array([t_len, t_len - 29, 40, 1])
    valid = (np.arange(t_len)[None] < lens[:, None]).astype(np.float32)
    ref = n(_fused_attn_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(valid), interpret=True)) * valid[..., None]
    three = n(_tf32_attention(t(q), t(k), t(v), t(valid), 3))
    one = n(_tf32_attention(t(q), t(k), t(v), t(valid), 1))
    assert np.abs(three - ref).max() <= 5e-5
    assert np.abs(one - ref).max() > 5e-5


def test_tf32_rounding_is_round_to_nearest_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0], dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0]
    assert _tf32(x).tolist() == want


def test_wrapper_takes_strided_and_float_validity(rng):
    """The key validity as the strided bool view ``mask[:, 0, 0, :]`` (what the
    blocks' 4-D mask gives, read in place by the CUDA kernels) and as 0/1 floats:
    the same output as a contiguous bool vector."""
    b, t_len, h, dh = 3, 50, 2, 8
    q, k, v = (t(x) for x in _qkv(rng, b, t_len, h, dh))
    valid = torch.arange(t_len)[None, :] < torch.tensor([50, 31, 1])[:, None]
    mask = valid[:, None, None, :] & valid[:, None, :, None]
    strided = mask[:, 0, 0, :]
    assert not strided.is_contiguous() and strided.stride() == (t_len * t_len, 1)
    want = A.fused_attention(q, k, v, valid)
    torch.testing.assert_close(A.fused_attention(q, k, v, strided), want, rtol=0, atol=0)
    torch.testing.assert_close(A.fused_attention(q, k, v, valid.float()), want, rtol=0, atol=0)
    torch.testing.assert_close(A.flash_attention_fn(q, k, v, mask=mask), want, rtol=0, atol=0)
