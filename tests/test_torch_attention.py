"""Fused attention of the port against the JAX package (f32, CPU).

On the CPU the wrapper runs its plain version; it is held against the TPU
kernel run in the Pallas interpreter and against ``flash_attention_fn``
forced onto that interpreter. The CUDA kernel itself is held against the
plain version in ``test_torch_cuda_kernels.py``, on the GPU.
"""

import functools

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


@pytest.mark.parametrize("t_len,dh", [(128, 64), (100, 16), (72, 128)])
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

