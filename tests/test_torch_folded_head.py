"""Folded BigVGAN head of the port (f32, CPU): the folded kernels equal the
JAX package's arrays; ``folded_conv`` and ``FoldedSnakeHead`` (all stages
folded, and folded after an unfolded stage) match the JAX ones and the
port's unfolded head; a folded JAX state loads through the strict
converter."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.models.vocoder import Vocos, VocosParams
from speechflow_torch.models.vocoder.folded_head import FoldedSnakeHead
from speechflow_torch.models.vocoder.heads import SnakeUpsampleHead
from speechflow_torch.ops import folded as fd
from tests.torch_parity import n, port, randomize, t, vocoder_params

torch.set_num_threads(1)
TOL = 1e-5
HEAD = dict(dim=12, upsample_rates=(2, 2, 2), channels=32, resblock_kernel_sizes=(3, 7),
            taps=8)


@pytest.fixture(scope="module")
def heads():
    """The JAX head with random weights and the port's copy of it."""
    from speechflow_tpu.models.vocoder.heads import SnakeUpsampleHead as J

    jh = randomize(J(**HEAD, remat=False, rngs=nnx.Rngs(0)), seed=3)
    return jh, port(SnakeUpsampleHead(**HEAD), jh)


@pytest.mark.parametrize("k,d,f", [(3, 1, 2), (7, 3, 4), (11, 5, 16), (4, 2, 3), (7, 1, 1)])
def test_fold_conv_kernel_equals_jax(rng, k, d, f):
    from speechflow_tpu.ops import folded as J

    w = rng.normal(size=(k, 3, 5)).astype(np.float32)
    (w_f, pad), (j_f, j_pad) = fd.fold_conv_kernel(w, f, d), J.fold_conv_kernel(w, f, d)
    assert pad == j_pad
    np.testing.assert_array_equal(w_f, j_f)


@pytest.mark.parametrize("k,r,f", [(8, 4, 1), (4, 2, 2), (4, 2, 8), (5, 3, 2)])
def test_fold_conv_transpose_kernel_equals_jax(rng, k, r, f):
    from speechflow_tpu.ops import folded as J

    w = rng.normal(size=(k, 3, 5)).astype(np.float32)
    (w_f, pad), (j_f, j_pad) = (fd.fold_conv_transpose_kernel(w, f, r),
                                J.fold_conv_transpose_kernel(w, f, r))
    assert pad == j_pad
    np.testing.assert_array_equal(w_f, j_f)


def test_fold_roundtrip_and_folded_conv(rng):
    from speechflow_tpu.ops import folded as J

    x = rng.normal(size=(2, 24, 6)).astype(np.float32)
    for f in (1, 2, 3, 4):
        np.testing.assert_array_equal(n(fd.unfold(fd.fold(t(x), f), 6)), x)
    xf = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w_f = rng.normal(size=(4, 12, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    ref = J.folded_conv(jnp.asarray(xf), jnp.asarray(w_f), (2, 1), jnp.asarray(b))
    np.testing.assert_allclose(n(fd.folded_conv(t(xf), t(w_f), (2, 1), t(b))), n(ref),
                               atol=TOL)
    np.testing.assert_allclose(n(fd.folded_conv(t(xf), t(w_f), (2, 1))), n(ref) - b, atol=TOL)


@pytest.mark.parametrize("threshold,frames", [(64, 16), (64, 11), (16, 16)])
def test_folded_head_matches_jax_and_unfolded(rng, heads, threshold, frames):
    """threshold 64 folds every stage; 16 leaves the first (C=16) unfolded."""
    from speechflow_tpu.models.vocoder.folded_head import FoldedSnakeHead as J

    jh, th = heads
    jf = J(jh, target=48, threshold=threshold)
    tf = FoldedSnakeHead(th, target=48, threshold=threshold)
    assert tf.geom == jf.geom
    assert (tf.geom[0][2] == 1) == (threshold == 16) and tf.geom[-1][2] > 1
    x = rng.normal(size=(2, frames, HEAD["dim"])).astype(np.float32)
    with torch.inference_mode():
        out, unfolded = n(tf(t(x))), n(th(t(x)))
    ref = n(jf(jnp.asarray(x)))
    assert out.shape == ref.shape == (2, frames * 8)
    np.testing.assert_allclose(out, ref, atol=TOL)
    np.testing.assert_allclose(out, unfolded, atol=TOL)
    assert np.abs(out).max() > 1e-2


def test_folded_jax_state_loads_through_the_strict_converter(rng):
    """A JAX Vocos folded after its weights were set: its pure dict (the
    inner head and the scattered kernels) loads into a port Vocos folded the
    same way, and both give the same waveform."""
    from speechflow_tpu.models.vocoder import Vocos as JV
    from speechflow_tpu.models.vocoder import VocosParams as JVP

    params = vocoder_params(upsample_rates=[2, 2, 2], upsample_channels=64,
                            resblock_kernel_sizes=[3, 7], hop_length=8)
    jm = randomize(JV(JVP.create(params), rngs=nnx.Rngs(1)), seed=5)
    assert jm.fold_inference(target=64, threshold=64)
    tm = Vocos(VocosParams.create(params))
    assert tm.fold_inference(target=64, threshold=64)
    tm = port(tm, jm)
    assert isinstance(tm.head, FoldedSnakeHead) and tm.head.geom == jm.head.geom
    mel = rng.normal(size=(2, 7, params["n_mels"])).astype(np.float32)
    with torch.inference_mode():
        out = n(tm.from_features(t(mel)))
    ref = n(jm.from_features(jnp.asarray(mel)))
    assert out.shape == ref.shape == (2, 6 * 8)
    np.testing.assert_allclose(out, ref, atol=TOL)


def test_fold_inference_keeps_other_heads():
    m = Vocos(VocosParams.create(vocoder_params(head="istft", n_fft=32, hop_length=8)))
    assert not m.fold_inference()
    assert type(m.head).__name__ == "ISTFTHead"
