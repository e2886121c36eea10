"""The conditioned acoustic model against the JAX package (f32, CPU): prosody
classes (``use_prosody``), a projected speaker embedding
(``speaker_emb_mode="input"``) and the reference-mel style encoder
(``use_style_encoder``, VAE and GMVAE) on the narrow flagship shape of
``tests/torch_parity.py``. Inference under the durations both predict (equal
first, then the mel within ``MODEL_TOL``); the training call with JAX's style
and CFM draws injected: every loss, ``vae_kl`` / ``gmvae_*`` included, and
every gradient within ``GRAD_TOL`` of its scale; fresh weights from flax's
initialisers."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.convert import flatten_nnx, nnx_from_module, state_dict_from_nnx
from speechflow_torch.models.tts import TTSCriterion
from speechflow_torch.models.tts.decoders import CFMDraws
from speechflow_torch.models.tts.model import ParallelTTSModel, ParallelTTSParams
from speechflow_torch.models.tts.predictors import GaussianMixtureVAE, StyleEncoder
from speechflow_torch.utils.masks import sequence_mask
from tests.test_torch_tts_train import _jax_target, _jin, _tin, _torch_target
from tests.torch_parity import (
    cfm_noise,
    jax_tts_input,
    jax_tts_model,
    n,
    port,
    t,
    torch_tts_input,
    tts_arrays,
    tts_params,
)

torch.set_num_threads(1)
MODEL_TOL = 2e-4  # the whole acoustic model in f32
GRAD_TOL = 2e-4   # each gradient, of its scale (as test_torch_tts_train)
B, N, N_MELS, T_REF = 2, 13, 12, 40
LENS = np.array([N, 9])
BIO = 10          # speaker_bio_dim
STYLE = 6         # style_emb_dim
STYLES = {"vae": dict(style_use_vae=True, style_use_gmvae=False),
          "gmvae": dict(style_use_gmvae=True, style_gmvae_components=4)}


def _params(style: str) -> dict:
    return tts_params(use_prosody=True, n_prosody_classes=5, speaker_emb_mode="input",
                      speaker_bio_dim=BIO, use_style_encoder=True, style_emb_dim=STYLE,
                      **STYLES[style])


def _pair(style: str):
    params = _params(style)
    jm = jax_tts_model(params)
    return jm, port(ParallelTTSModel(ParallelTTSParams.create(params)), jm), params


def _conditioning(rng, arrays: dict, t_mel: int) -> dict:
    """Prosody classes (-1 undefined, some beyond the table: the lookup clips),
    a speaker embedding, and a reference mel with ragged lengths."""
    valid = np.arange(N)[None] < LENS[:, None]
    ref_lens = np.asarray([t_mel, t_mel - 13], np.int32)
    frames = np.arange(t_mel)[None] < ref_lens[:, None]
    arrays.update(
        prosody=np.where(valid, rng.integers(-1, 8, (B, N)), -1).astype(np.int32),
        speaker_emb=rng.normal(size=(B, BIO)).astype(np.float32),
        mel=(rng.normal(size=(B, t_mel, N_MELS)) * frames[..., None]).astype(np.float32),
        mel_lengths=ref_lens)
    return arrays


@pytest.mark.parametrize("style", list(STYLES))
def test_inference_matches_jax(style):
    jm, tm, params = _pair(style)
    rng = np.random.default_rng(0)
    arrays = _conditioning(rng, tts_arrays(rng, B, N, LENS), T_REF)
    arrays.pop("durations")
    t_out = params["max_output_length"]
    noise = cfm_noise(jm, (B, t_out, N_MELS))
    ref = jm(jax_tts_input(arrays), training=False, t_out=t_out)
    out = tm(torch_tts_input(arrays), t_out=t_out, noise=t(noise))
    durs, ref_durs = n(out.attention).sum(1), n(ref.attention).sum(1)
    np.testing.assert_array_equal(durs, ref_durs)
    assert durs.sum(1).max() < t_out
    frames = n(sequence_mask(out.spectrogram_lengths, t_out)).astype(bool)
    for stage in range(2):
        np.testing.assert_allclose(n(out.spectrogram[stage])[frames],
                                   n(ref.spectrogram[stage])[frames], atol=MODEL_TOL)
    # the VAE's KL is reported at inference too (its mu and logvar exist), the GMVAE's
    # losses only when it samples
    assert set(out.additional_losses) == set(ref.additional_losses) == (
        {"vae_kl"} if style == "vae" else set())
    for k, v in ref.additional_losses.items():
        np.testing.assert_allclose(float(out.additional_losses[k].detach()), float(v),
                                   rtol=MODEL_TOL)
    # each conditioning input moves the output
    for name, value in (("prosody", np.full((B, N), 2, np.int32)),
                        ("speaker_emb", arrays["speaker_emb"][::-1].copy()),
                        ("mel", arrays["mel"] * 0.5)):
        other = tm(torch_tts_input(dict(arrays, **{name: value})), t_out=t_out,
                   noise=t(noise))
        assert (n(other.additional_content["cfm_prior"])
                != n(out.additional_content["cfm_prior"])).any(), name


def _train_arrays(seed: int) -> dict:
    """A training batch: tokens and features, 2..5 frames a token, the target
    mel as the style reference, the gate."""
    rng = np.random.default_rng(seed)
    arrays = tts_arrays(rng, B, N, LENS)
    mel_lens = arrays["durations"].sum(1).astype(np.int32)
    t_mel = 72
    arrays = _conditioning(rng, arrays, t_mel)
    frames = np.arange(t_mel)[None] < mel_lens[:, None]
    valid = np.arange(N)[None] < LENS[:, None]
    arrays.update(
        mel=(rng.normal(size=(B, t_mel, N_MELS)) * frames[..., None]).astype(np.float32),
        mel_lengths=mel_lens,
        aggregate_pitch=(rng.uniform(80, 300, (B, N)) * valid).astype(np.float32),
        aggregate_energy=(rng.uniform(0, 20, (B, N)) * valid).astype(np.float32),
        gate=(np.arange(t_mel)[None] >= mel_lens[:, None] - 1).astype(np.float32))
    return arrays


def _jax_draws(jm, shape):
    """The style sample's ε and the CFM's u, z and CFG masks that the JAX model's
    next training call draws, in its order (the style encoder first; one rng
    stream for the model), from a clone."""
    c = nnx.clone(jm)
    eps = jax.random.normal(c.style_encoder.rngs.params(), (B, STYLE))
    dec = c.decoder
    k1, k2, k3, k4 = jax.random.split(dec.rngs.params(), 4)
    draws = CFMDraws(t(jax.random.uniform(k1, (B,))), t(jax.random.normal(k2, shape)),
                     t(jax.random.bernoulli(k3, dec.cfg_dropout, (B, 1, 1))),
                     t(jax.random.bernoulli(k4, dec.cfg_dropout, (B, 1))))
    return t(eps), draws


def _criteria():
    from speechflow_tpu.models.tts import TTSCriterion as JCrit

    from speechflow_torch.scripts.train_tts import configs

    loss = configs("debug")[0]["loss"]
    return JCrit(**loss), TTSCriterion(**loss)


@pytest.mark.parametrize("style", list(STYLES))
def test_training_call_and_gradients_match_jax(style):
    """Teacher-forced with the style sample drawn (the training call): the
    losses, the style losses among them, and every parameter's gradient."""
    jm, tm, _ = _pair(style)
    arrays = _train_arrays(1)
    eps, draws = _jax_draws(jm, arrays["mel"].shape)
    jcrit, tcrit = _criteria()
    jin, jtgt = _jin(arrays), _jax_target(arrays)
    seen = {}

    def loss_fn(m):
        out = m(jin, training=True, deterministic=True)
        losses = jcrit(out, jtgt, jnp.asarray(0, jnp.int32))
        seen.update(out.additional_losses)
        return sum(losses.values()), losses

    (jloss, jlosses), jgrads = nnx.value_and_grad(loss_fn, has_aux=True)(jm)
    out = tm(_tin(arrays), training=True, deterministic=True, cfm_draws=draws,
             style_eps=eps)
    losses = tcrit(out, _torch_target(arrays), 0)
    style_losses = {"vae": {"vae_kl"}, "gmvae": {"gmvae_gm", "gmvae_cat"}}[style]
    assert set(out.additional_losses) == set(seen) == {"cfm"} | style_losses
    assert set(losses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k].detach()), float(jlosses[k]), rtol=MODEL_TOL,
                                   atol=1e-6, err_msg=k)
    loss = sum(losses.values())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=MODEL_TOL)
    ref = state_dict_from_nnx(tm, nnx.to_pure_dict(jgrads))
    model_scale = max(np.abs(n(r)).max() for r in ref.values())
    for name, p in tm.named_parameters():
        g, r = n(p.grad) if p.grad is not None else np.zeros(p.shape), n(ref[name])
        scale = max(np.abs(r).max(), 1e-3 * model_scale)
        assert np.abs(g - r).max() <= GRAD_TOL * scale, name
    for prefix in ("style_encoder.", "speaker_proj.", "prosody_emb."):
        assert any(np.abs(n(p.grad)).max() > 0 for k, p in tm.named_parameters()
                   if k.startswith(prefix)), prefix


@pytest.mark.parametrize("style", list(STYLES))
def test_fresh_weights_follow_flax_initialisers(style):
    """As ``test_torch_tts_train``'s check: constant tensors equal (zero biases,
    unit scales, the GMVAE's -1 prior log-variances), drawn ones of the JAX
    tensor's standard deviation (the GMVAE's uniform(-2, 2) prior means too)."""
    from speechflow_tpu.models.tts import ParallelTTSModel as J
    from speechflow_tpu.models.tts import ParallelTTSParams as JP

    params = _params(style)
    ref = flatten_nnx(nnx.to_pure_dict(nnx.state(J(JP.create(params), rngs=nnx.Rngs(0)),
                                                 nnx.Param)))
    torch.manual_seed(0)
    got = flatten_nnx(nnx_from_module(ParallelTTSModel(ParallelTTSParams.create(params))))
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, k
        if (r == r.flat[0]).all():
            np.testing.assert_array_equal(g, r, err_msg=k)
            continue
        assert abs(g.std() / r.std() - 1) <= 6 / np.sqrt(r.size), k
        assert abs(g.mean() - r.mean()) <= 6 * r.std() / np.sqrt(r.size), k


def test_style_encoder_draws():
    """Without ``eps`` the sample comes from the generator; ``mean_priors`` can
    be given; deterministic calls draw nothing."""
    enc = StyleEncoder(N_MELS, dim=16, emb_dim=STYLE)
    mel = torch.randn(B, 20, N_MELS)
    z0, _ = enc(mel, deterministic=True)
    z1, (mu, logvar) = enc(mel, deterministic=False, generator=torch.Generator().manual_seed(1))
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(1))
    z2, _ = enc(mel, deterministic=False, eps=eps)
    torch.testing.assert_close(z0, mu)
    torch.testing.assert_close(z1, z2)
    prior = torch.arange(12.0).reshape(3, 4)
    gm = GaussianMixtureVAE(16, 4, 3, mean_priors=prior)
    torch.testing.assert_close(gm.mean_priors.detach(), prior)
    z, losses = gm(torch.randn(B, 16), deterministic=False, eps=torch.zeros(B, 4))
    assert set(losses) == {"gmvae_gm", "gmvae_cat"} and math.isfinite(losses["gmvae_gm"].item())


def test_conditioning_needs_its_inputs():
    tm = ParallelTTSModel(ParallelTTSParams.create(_params("vae"))).eval()
    arrays = _conditioning(np.random.default_rng(2), tts_arrays(np.random.default_rng(2), B, N,
                                                                LENS), T_REF)
    x = torch_tts_input(arrays)
    with pytest.raises(ValueError, match="speaker_emb"):
        tm(dataclasses.replace(x, speaker_emb=None), t_out=32)
    with pytest.raises(ValueError, match="mel"):
        tm(dataclasses.replace(x, mel=None, mel_lengths=None), t_out=32)
    # any mode but "table" projects speaker_emb, as the JAX model builds it
    bio = ParallelTTSModel(ParallelTTSParams.create(tts_params(speaker_emb_mode="bio")))
    assert hasattr(bio, "speaker_proj") and not hasattr(bio, "speaker_emb")
    with pytest.raises(ValueError, match="speaker_emb"):
        bio.eval()(dataclasses.replace(x, speaker_emb=None), t_out=32)
