"""Layout traps between flax nnx and the port (f32, CPU, 1e-6): each layer
built in flax with random weights, converted, and run on the same input."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.convert import flatten_nnx, state_dict_from_nnx
from speechflow_torch.models.layers import Conv1d, ConvTranspose1d, MultiHeadAttention, layer_norm
from speechflow_torch.models.tts.common import gelu
from speechflow_torch.ops.signal import depthwise_conv1d
from tests.torch_parity import n, port, randomize, t

torch.set_num_threads(1)
TOL = 1e-6


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_linear_kernel_is_in_out(rng):
    jm = randomize(nnx.Linear(5, 7, rngs=nnx.Rngs(0)))
    tm = port(torch.nn.Linear(5, 7), jm)
    x = _x(rng, 3, 4, 5)
    np.testing.assert_allclose(n(tm(t(x))), n(jm(jnp.asarray(x))), atol=TOL)


@pytest.mark.parametrize("k,d", [(3, 1), (4, 1), (2, 1), (5, 2), (7, 3), (11, 5), (6, 2)])
def test_conv_same_padding(rng, k, d):
    jm = randomize(nnx.Conv(4, 6, (k,), kernel_dilation=(d,), padding="SAME",
                            rngs=nnx.Rngs(0)))
    tm = port(Conv1d(4, 6, k, dilation=d), jm)
    x = _x(rng, 2, 19, 4)
    np.testing.assert_allclose(n(tm(t(x))), n(jm(jnp.asarray(x))), atol=TOL)


@pytest.mark.parametrize("k", [7, 4])
def test_depthwise_conv_layout(rng, k):
    from speechflow_tpu.ops.signal import depthwise_conv1d as jax_depthwise

    c = 6
    jm = randomize(nnx.Conv(c, c, (k,), padding="SAME", feature_group_count=c,
                            rngs=nnx.Rngs(0)))
    assert jm.kernel[...].shape == (k, 1, c)
    tm = port(Conv1d(c, c, k, groups=c), jm)
    x = _x(rng, 2, 17, c)
    ref = n(jm(jnp.asarray(x)))
    np.testing.assert_allclose(n(tm(t(x))), ref, atol=TOL)
    np.testing.assert_allclose(n(depthwise_conv1d(t(x), tm.weight, tm.bias)), ref, atol=TOL)
    np.testing.assert_allclose(
        n(jax_depthwise(jnp.asarray(x), jm.kernel[...], jm.bias[...])), ref, atol=TOL)


@pytest.mark.parametrize("r,k", [(4, 8), (2, 4), (8, 16), (3, 5), (2, 2)])
def test_conv_transpose_same_unflipped(rng, r, k):
    jm = randomize(nnx.ConvTranspose(4, 3, (k,), strides=(r,), padding="SAME",
                                     rngs=nnx.Rngs(0)))
    assert jm.kernel[...].shape == (k, 4, 3)
    tm = port(ConvTranspose1d(4, 3, k, r), jm)
    x = _x(rng, 2, 9, 4)
    ref = n(jm(jnp.asarray(x)))
    out = n(tm(t(x)))
    assert out.shape == ref.shape == (2, 9 * r, 3)
    np.testing.assert_allclose(out, ref, atol=TOL)


def test_multi_head_attention_layout(rng):
    jm = randomize(nnx.MultiHeadAttention(num_heads=2, in_features=8, qkv_features=8,
                                          decode=False, rngs=nnx.Rngs(0)))
    assert jm.query.kernel[...].shape == (8, 2, 4)
    assert jm.out.kernel[...].shape == (2, 4, 8)
    tm = port(MultiHeadAttention(8, 2), jm)
    x = _x(rng, 2, 11, 8)
    ref = n(jm(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), deterministic=True))
    np.testing.assert_allclose(n(tm(t(x))), ref, atol=TOL)


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_eps(rng, affine):
    jm = randomize(nnx.LayerNorm(16, use_bias=affine, use_scale=affine, rngs=nnx.Rngs(0)))
    tm = port(layer_norm(16, affine), jm)
    # variance ~1e-6: torch's default eps=1e-5 would be off by ~40%
    x = _x(rng, 3, 16) * 1e-3
    np.testing.assert_allclose(n(tm(t(x))), n(jm(jnp.asarray(x))), atol=2 * TOL, rtol=TOL)


def test_gelu_is_tanh_approximation(rng):
    x = _x(rng, 1000) * 3
    np.testing.assert_allclose(n(gelu(t(x))), n(nnx.gelu(jnp.asarray(x))), atol=TOL)
    assert np.abs(n(torch.nn.functional.gelu(t(x))) - n(gelu(t(x)))).max() > 1e-4


def test_embedding(rng):
    jm = randomize(nnx.Embed(10, 4, rngs=nnx.Rngs(0)))
    tm = port(torch.nn.Embedding(10, 4), jm)
    ids = rng.integers(0, 10, (2, 5))
    np.testing.assert_allclose(n(tm(t(ids))), n(jm(jnp.asarray(ids))), atol=0)


def test_converter_is_strict():
    jm = randomize(nnx.Linear(5, 7, rngs=nnx.Rngs(0)))
    pure = nnx.to_pure_dict(nnx.state(jm))
    with pytest.raises(ValueError):
        state_dict_from_nnx(torch.nn.Linear(5, 6), pure)
    with pytest.raises(KeyError):
        state_dict_from_nnx(torch.nn.Linear(5, 7, bias=False), pure)
    dropout = nnx.Dropout(0.1, rngs=nnx.Rngs(0))
    assert flatten_nnx(nnx.to_pure_dict(nnx.state(dropout))) == {}
