"""Acoustic model of the port against the JAX package (f32, CPU).

Blocks, encoders, predictors, the variance adaptor under given durations,
``CFMDecoder.generate`` with the JAX decoder's own initial noise, and
``ParallelTTSModel`` inference at a narrow flagship-shaped config (CFM with
batched CFG, ling/LM/XPBERT features, two languages, gate). Every JAX model
gets seeded random weights (``randomize``) that the converter copies into the
port. Attention on the JAX side is flax's CPU fallback, which leaves a
uniform average in padded query rows where the port writes zeros: rows are
compared where they are valid, and every stage masks its output.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.models.tts import common as C
from speechflow_torch.models.tts.decoders import CFMDecoder
from speechflow_torch.models.tts.encoders import DiTEncoder, TransformerEncoder
from speechflow_torch.models.tts.model import ParallelTTSModel, ParallelTTSParams
from speechflow_torch.models.tts.predictors import TokenLevelDP, VariancePredictor
from speechflow_torch.models.tts.variance_adaptor import (
    HierarchicalVarianceAdaptor,
    VarianceConfig,
)
from speechflow_torch.ops import length_regulator as LR
from speechflow_torch.utils.masks import sequence_mask
from tests.torch_parity import (
    VARIANCES,
    D,
    cfm_noise,
    jax_tts_input,
    jax_tts_model,
    n,
    port,
    randomize,
    t,
    torch_tts_input,
    tts_arrays,
    tts_params,
)

torch.set_num_threads(1)
TOL = 2e-5        # one block or stage in f32
MODEL_TOL = 2e-4  # the whole acoustic model: ~40 f32 layers and 4 Euler steps

B, N = 2, 13
LENS = np.array([N, 9])
VALID = np.arange(N)[None] < LENS[:, None]


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close_valid(out, ref, valid, tol):
    out, ref = n(out), n(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out[valid], ref[valid], atol=tol, rtol=tol)


def test_sinusoidal_and_rope(rng):
    from speechflow_tpu.models.tts import common as J

    pos = rng.uniform(0, 1000, (3, 5)).astype(np.float32)
    np.testing.assert_allclose(n(C.sinusoidal_embedding(t(pos), 16)),
                               n(J.sinusoidal_embedding(jnp.asarray(pos), 16)),
                               atol=1e-4)  # sin/cos of arguments up to 1e3
    for d in (16, 7):
        x = _x(rng, 2, 11, d)
        np.testing.assert_allclose(n(C.rope_rotate(t(x))), n(J.rope_rotate(jnp.asarray(x))),
                                   atol=TOL)


@pytest.mark.parametrize("method", ["cat", "add", "adanorm", "film"])
@pytest.mark.parametrize("cond_ndim", [2, 3])
def test_conditional_layer(rng, method, cond_ndim):
    from speechflow_tpu.models.tts.common import ConditionalLayer

    jm = randomize(ConditionalLayer(method, D, 6, rngs=nnx.Rngs(0)))
    tm = port(C.ConditionalLayer(method, D, 6), jm)
    x = _x(rng, B, N, D)
    cond = _x(rng, B, 6) if cond_ndim == 2 else _x(rng, B, N, 6)
    np.testing.assert_allclose(n(tm(t(x), t(cond))), n(jm(jnp.asarray(x), jnp.asarray(cond))),
                               atol=TOL)


def test_conv_stack(rng):
    from speechflow_tpu.models.tts.common import ConvStack

    jm = randomize(ConvStack(D, 24, 8, n_layers=3, kernel_size=5, rngs=nnx.Rngs(0)))
    tm = port(C.ConvStack(D, 24, 8, n_layers=3, kernel_size=5), jm)
    x = _x(rng, B, N, D)
    np.testing.assert_allclose(n(tm(t(x))), n(jm(jnp.asarray(x))), atol=TOL)


@pytest.mark.parametrize("kind", ["transformer", "dit"])
def test_blocks(rng, kind):
    from speechflow_tpu.models.tts import common as J

    x, cond = _x(rng, B, N, D), _x(rng, B, 10)
    if kind == "transformer":
        jm = randomize(J.TransformerBlock(D, 2, rngs=nnx.Rngs(0)))
        tm = port(C.TransformerBlock(D, 2), jm)
        ref = jm(jnp.asarray(x), jnp.asarray(VALID))
        out = tm(t(x), t(VALID))
    else:
        jm = randomize(J.DiTBlock(D, 10, 2, rngs=nnx.Rngs(0)))
        tm = port(C.DiTBlock(D, 10, 2), jm)
        ref = jm(jnp.asarray(x), jnp.asarray(cond), jnp.asarray(VALID))
        out = tm(t(x), t(cond), t(VALID))
    _close_valid(out, ref, VALID, TOL)


@pytest.mark.parametrize("kind", ["transformer", "dit"])
def test_encoders(rng, kind):
    from speechflow_tpu.models.tts import encoders as J

    x, cond = _x(rng, B, N, 12), _x(rng, B, 10)
    if kind == "transformer":
        jm = randomize(J.TransformerEncoder(12, 20, D, 2, 2, rngs=nnx.Rngs(0)))
        tm = port(TransformerEncoder(12, 20, D, 2, 2), jm)
    else:
        jm = randomize(J.DiTEncoder(12, 20, D, 2, 2, cond_dim=10, rngs=nnx.Rngs(0)))
        tm = port(DiTEncoder(12, 20, D, 2, 2, cond_dim=10), jm)
    ref = n(jm(jnp.asarray(x), jnp.asarray(LENS), jnp.asarray(cond)))
    out = n(tm(t(x), t(LENS), t(cond)))
    np.testing.assert_allclose(out, ref, atol=TOL)  # padded rows are masked to 0 in both


def test_length_regulator(rng):
    from speechflow_tpu.ops.length_regulator import length_regulate_hard

    durs = np.where(VALID, rng.integers(0, 5, (B, N)), 0).astype(np.float32)
    x = _x(rng, B, N, D)
    ref, ref_attn = length_regulate_hard(jnp.asarray(x), jnp.asarray(durs), 40)
    out, attn = LR.length_regulate_hard(t(x), t(durs), 40)
    np.testing.assert_array_equal(n(attn), n(ref_attn))
    np.testing.assert_allclose(n(out), n(ref), atol=TOL)


def test_predictors(rng):
    from speechflow_tpu.models.tts import predictors as J

    x = _x(rng, B, N, D)
    jv = randomize(J.VariancePredictor(D, 24, 3, 5, rngs=nnx.Rngs(0)))
    tv = port(VariancePredictor(D, 24, 3, 5), jv)
    np.testing.assert_allclose(n(tv(t(x), t(LENS))), n(jv(jnp.asarray(x), jnp.asarray(LENS))),
                               atol=TOL)
    jd = randomize(J.TokenLevelDP(D, 24, rngs=nnx.Rngs(1)))
    td = port(TokenLevelDP(D, 24), jd)
    log_d = td(t(x), t(LENS))
    ref = jd(jnp.asarray(x), jnp.asarray(LENS))
    np.testing.assert_allclose(n(log_d), n(ref), atol=TOL)
    np.testing.assert_allclose(n(TokenLevelDP.to_durations(log_d, t(LENS))),
                               n(J.TokenLevelDP.to_durations(ref, jnp.asarray(LENS))),
                               atol=TOL)


@pytest.mark.parametrize("training", [True, False])
def test_variance_adaptor(rng, training):
    """training=True: the teacher-forced branch holds the regulator under the
    given durations; training=False: predicted, rounded durations."""
    from speechflow_tpu.models.tts import variance_adaptor as J

    jm = randomize(J.HierarchicalVarianceAdaptor(
        D, [J.VarianceConfig(**v) for v in VARIANCES], rngs=nnx.Rngs(0)))
    # durations of a few frames a token: log(1 + 3) at the predictor's output
    jm.predictors["durations"].out.bias[...] = jnp.full((1,), math.log(4.0))
    tm = port(HierarchicalVarianceAdaptor(D, [VarianceConfig(**v) for v in VARIANCES]), jm)
    x = _x(rng, B, N, D) * VALID[..., None]
    arrays = tts_arrays(rng, B, N, LENS)
    t_out = 80
    ref = jm(jnp.asarray(x), jnp.asarray(LENS), jax_tts_input(arrays), t_out,
             training=training)
    out = tm(t(x), t(LENS), torch_tts_input(arrays), t_out, training=training)
    np.testing.assert_array_equal(n(out[1]), n(ref[1]))   # frame lengths
    np.testing.assert_array_equal(n(out[3]), n(ref[3]))   # the alignment
    if training:
        np.testing.assert_array_equal(n(out[3]).sum(1), arrays["durations"])
    np.testing.assert_allclose(n(out[0]), n(ref[0]), atol=TOL)
    for name, pred in ref[2].items():
        np.testing.assert_allclose(n(out[2][name]), n(pred), atol=TOL)


@pytest.mark.parametrize("cfg_scale", [0.0, 1.0])
def test_cfm_generate_with_injected_noise(rng, cfg_scale):
    from speechflow_tpu.models.tts.decoders import CFMDecoder as J

    jm = randomize(J(dim_in=20, dim_out=12, dim=D, n_layers=2, n_heads=2, cond_dim=10,
                     n_timesteps=5, cfg_scale=cfg_scale, rngs=nnx.Rngs(3)))
    tm = port(CFMDecoder(dim_in=20, dim_out=12, dim=D, n_layers=2, n_heads=2, cond_dim=10,
                         n_timesteps=5, cfg_scale=cfg_scale), jm)
    t_len = 24
    lens = np.array([t_len, 17])
    content = _x(rng, B, t_len, 20) * (np.arange(t_len)[None] < lens[:, None])[..., None]
    cond = _x(rng, B, 10)
    noise = cfm_noise(jm, (B, t_len, 12))
    mu_ref, x_ref = jm.generate(jnp.asarray(content), jnp.asarray(lens), jnp.asarray(cond))
    mu, x = tm.generate(t(content), t(lens), t(cond), t(noise))
    np.testing.assert_allclose(n(mu), n(mu_ref), atol=TOL)
    np.testing.assert_allclose(n(x), n(x_ref), atol=1e-4)  # 5 Euler steps of 2 DiT blocks


def test_parallel_tts_inference_matches_jax(rng):
    params = tts_params()
    jm = jax_tts_model(params)
    tm = port(ParallelTTSModel(ParallelTTSParams.create(params)), jm)
    arrays = tts_arrays(rng, B, N, LENS)
    t_out = params["max_output_length"]
    noise = cfm_noise(jm, (B, t_out, params["n_mels"]))
    ref = jm(jax_tts_input(arrays), training=False, t_out=t_out)
    out = tm(torch_tts_input(arrays), t_out=t_out, noise=t(noise))

    # predicted, rounded durations first: everything after depends on them
    durs, ref_durs = n(out.attention).sum(1), n(ref.attention).sum(1)
    np.testing.assert_array_equal(durs, ref_durs)
    assert (durs[VALID] > 0).any() and durs.sum(1).max() < t_out  # no frame cut off
    np.testing.assert_array_equal(n(out.spectrogram_lengths), n(ref.spectrogram_lengths))
    frames = n(sequence_mask(out.spectrogram_lengths, t_out)).astype(bool)
    for stage in range(2):  # decoder output, after postnet
        _close_valid(out.spectrogram[stage], ref.spectrogram[stage], frames, MODEL_TOL)
    _close_valid(out.gate, ref.gate, frames, MODEL_TOL)
    np.testing.assert_allclose(n(out.additional_content["cfm_prior"]),
                               n(ref.additional_content["cfm_prior"]), atol=TOL)
    assert n(out.spectrogram[1])[~frames].max(initial=0) == 0.0


def test_noise_from_generator_is_scaled_by_temperature():
    params = tts_params()
    tm = ParallelTTSModel(ParallelTTSParams.create(params)).eval()
    arrays = tts_arrays(np.random.default_rng(1), B, N, LENS)
    x = torch_tts_input(arrays)
    a = tm(x, t_out=32, generator=torch.Generator().manual_seed(5))
    noise = torch.randn((B, 32, 12), generator=torch.Generator().manual_seed(5)) * 0.667
    b = tm(x, t_out=32, noise=noise)
    torch.testing.assert_close(a.spectrogram, b.spectrogram, rtol=0, atol=0)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        ParallelTTSModel(ParallelTTSParams.create(tts_params(use_style_encoder=True)))
    with pytest.raises(NotImplementedError):
        VarianceConfig(name="aggregate_pitch", as_embedding=True)
