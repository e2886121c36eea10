"""The training-side ops and models of the port against the JAX package (f32,
CPU): the anti-alias VJPs against ``jax.vjp`` of the JAX ops, the gradients of
the loss-side DSP ops, the CQT, every discriminator's logits and feature maps,
and the vocoder criteria with their gradient with respect to the fake
waveform."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.models.vocoder import discriminators as D
from speechflow_torch.models.vocoder import extra_discriminators as XD
from speechflow_torch.models.vocoder.criterion import (
    mel_reconstruction_loss,
    multires_stft_loss,
    vocoder_disc_criterion,
    vocoder_gen_criterion,
)
from speechflow_torch.ops import anti_alias as AA
from speechflow_torch.ops import mel as M
from speechflow_torch.ops import stft as S
from speechflow_torch.ops.cqt import cqt
from speechflow_torch.convert import load_nnx_state
from tests.torch_parity import n, port, randomize, t

torch.set_num_threads(1)
VJP_TOL = 1e-5  # f32, of the JAX gradient's largest magnitude (sums in another order)
TOL = 1e-5


def _close(got, ref, tol=VJP_TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(n(got), ref, atol=tol * max(1.0, np.abs(ref).max()), rtol=0)


# -- anti-alias VJPs ---------------------------------------------------------------


@pytest.mark.parametrize("taps", [6, 8, 12])
@pytest.mark.parametrize("shape", [(2, 37, 5), (1, 130, 3), (2, 3, 4)])
def test_anti_alias_vjps_match_jax(taps, shape):
    """T not a multiple of 64, odd C, and T shorter than the filter."""
    from speechflow_tpu.ops import anti_alias as J

    rng = np.random.default_rng(taps)
    c = shape[-1]
    x, g, g2 = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    a, b = (0.3 * rng.normal(size=c)).astype(np.float32), (0.3 * rng.normal(size=c)).astype(
        np.float32)

    _, vjp = jax.vjp(lambda *v: J.anti_alias_snake(*v, taps=taps, remat=True),
                     jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    for got, ref in zip(AA.anti_alias_snake_vjp(t(x), t(a), t(b), t(g), taps),
                        vjp(jnp.asarray(g))):
        _close(got, ref)

    (ye, yo), vjp = jax.vjp(lambda v: J.aa_upsample_fir(v, taps), jnp.asarray(x))
    _close(AA.aa_upsample_fir_vjp(t(g), t(g2), taps), vjp((jnp.asarray(g), jnp.asarray(g2)))[0])

    _, vjp = jax.vjp(lambda *v: J.aa_snake_downsample(*v, taps=taps), ye, yo,
                     jnp.asarray(a), jnp.asarray(b))
    for got, ref in zip(AA.aa_snake_downsample_vjp(t(ye), t(yo), t(a), t(b), t(g), taps),
                        vjp(jnp.asarray(g))):
        _close(got, ref)


def test_anti_alias_vjps_keep_the_input_dtype():
    x = torch.randn(1, 50, 3).to(torch.bfloat16)
    a, b, g = torch.zeros(3), torch.zeros(3), torch.randn(1, 50, 3).to(torch.bfloat16)
    dx, da, db = AA.anti_alias_snake_vjp(x, a, b, g)
    assert (dx.dtype, da.dtype, db.dtype) == (torch.bfloat16, torch.float32, torch.float32)
    assert AA.aa_upsample_fir_vjp(g, None).dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_anti_alias_vjps_on_cpu_tensors_are_the_plain_versions(dtype):
    """On CPU tensors each VJP is its plain version, bit for bit, and counts no launch."""
    gen = torch.Generator().manual_seed(3)
    x, g, h = (torch.randn(2, 45, 7, generator=gen).to(dtype) for _ in range(3))
    a, b = 0.3 * torch.randn(7, generator=gen), 0.3 * torch.randn(7, generator=gen)
    ye, yo = AA.aa_upsample_fir_reference(x)
    launches = [AA.anti_alias_snake_vjp.launches, AA.aa_upsample_fir_vjp.launches,
                AA.aa_snake_downsample_vjp.launches]
    pairs = [(AA.anti_alias_snake_vjp(x, a, b, g), AA.anti_alias_snake_vjp_reference(x, a, b, g)),
             ((AA.aa_upsample_fir_vjp(g, h),), (AA.aa_upsample_fir_vjp_reference(g, h),)),
             ((AA.aa_upsample_fir_vjp(None, h),), (AA.aa_upsample_fir_vjp_reference(None, h),)),
             (AA.aa_snake_downsample_vjp(ye, yo, a, b, g),
              AA.aa_snake_downsample_vjp_reference(ye, yo, a, b, g))]
    for got, ref in pairs:
        assert all(u.dtype == v.dtype and torch.equal(u, v) for u, v in zip(got, ref))
    assert launches == [AA.anti_alias_snake_vjp.launches, AA.aa_upsample_fir_vjp.launches,
                        AA.aa_snake_downsample_vjp.launches]


# -- loss-side DSP gradients -------------------------------------------------------


def test_loss_side_ops_give_jax_gradients(rng):
    """|STFT| -> mel -> dB, with frames that clip at a_min (a zero stretch)."""
    from speechflow_tpu import ops as J

    w = rng.normal(size=(2, 3000)).astype(np.float32) * 0.1
    w[:, 1000:2200] = 0.0
    ct = rng.normal(size=(2, 3000 // 256 + 1, 40)).astype(np.float32)

    def jf(v):
        return jnp.sum(J.amp_to_db(J.linear_to_mel(J.magnitude(v, 1024, 256), 24000, 40))
                       * ct)

    x = t(w).requires_grad_()
    out = M.amp_to_db(M.linear_to_mel(S.magnitude(x, 1024, 256), 24000, 40))
    (out * t(ct)).sum().backward()
    _close(x.grad, jax.grad(jf)(jnp.asarray(w)), 1e-5)

    edge = np.array([1e-5, 2e-5, 1e-6, 0.5], np.float32)  # a tie at a_min
    e = t(edge).requires_grad_()
    M.amp_to_db(e).sum().backward()
    np.testing.assert_allclose(n(e.grad), jax.grad(lambda v: J.amp_to_db(v).sum())(edge),
                               rtol=1e-6)


def test_cached_dsp_constants_serve_autograd_after_inference():
    """Windows, filterbanks and FIR taps are cached per device; one first built
    under ``inference_mode`` (a serving call) must still serve a training loss."""
    from speechflow_torch.ops import cqt as C

    for fn in (S._default_window, S._default_window_sum, M._matrix_on, C._on):
        fn.cache_clear()
    with torch.inference_mode():
        M.amp_to_db(M.linear_to_mel(S.magnitude(torch.randn(1, 3000), 512, 128), 24000, 40))
        S.istft(torch.randn(1, 9, 257, dtype=torch.complex64), 512, 128)
        cqt(torch.randn(1, 3000), 24000, 256)
    x = torch.randn(1, 3000, requires_grad=True)
    loss = M.amp_to_db(M.linear_to_mel(S.magnitude(x, 512, 128), 24000, 40)).sum()
    (loss + S.istft(torch.fft.rfft(x.unfold(-1, 512, 128), dim=-1), 512, 128).sum()
     + cqt(x, 24000, 256).sum()).backward()
    assert torch.isfinite(x.grad).all()


# -- CQT and discriminators ---------------------------------------------------------


@pytest.mark.parametrize("hop,bins", [(512, 24), (256, 36), (256, 48)])
def test_cqt_matches_jax(rng, hop, bins):
    from speechflow_tpu.ops.cqt import cqt as jcqt

    w = rng.normal(size=(2, 5000)).astype(np.float32) * 0.2
    ref = np.asarray(jcqt(jnp.asarray(w), 24000, hop, bins_per_octave=bins))
    got = n(cqt(t(w), 24000, hop, bins_per_octave=bins))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL * np.abs(ref).max())


def test_cqt_checks_its_arguments():
    with pytest.raises(ValueError, match="divisible"):
        cqt(torch.zeros(1, 1000), 24000, 100)
    with pytest.raises(ValueError, match="nyquist"):
        cqt(torch.zeros(1, 1000), 8000, 256, upsample=False)


def _discs():
    from speechflow_tpu.models.vocoder import discriminators as JD
    from speechflow_tpu.models.vocoder import extra_discriminators as JX

    r = nnx.Rngs(0)
    return [
        ("period", JD.PeriodDiscriminator(3, 4, rngs=r), D.PeriodDiscriminator(3, 4)),
        ("mpd", JD.MultiPeriodDiscriminator((2, 5), 4, rngs=r),
         D.MultiPeriodDiscriminator((2, 5), 4)),
        ("mrd", JD.MultiResolutionDiscriminator(((512, 128), (256, 64)), 4, rngs=r),
         D.MultiResolutionDiscriminator(((512, 128), (256, 64)), 4)),
        ("vocoder_cqt", JD.VocoderDiscriminator((2, 3), channels=4, use_cqt=True, rngs=r),
         D.VocoderDiscriminator((2, 3), channels=4, use_cqt=True)),
        ("vocoder_mrd", JD.VocoderDiscriminator((2,), ((512, 128),), channels=4, rngs=r),
         D.VocoderDiscriminator((2,), ((512, 128),), channels=4)),
        ("multiband", JX.MultiBandDiscriminator(512, 128, channels=4, rngs=r),
         XD.MultiBandDiscriminator(512, 128, channels=4)),
        ("logfreq", JX.MultiScaleLogFreqDiscriminator(((512, 128), (256, 64)), channels=4,
                                                      rngs=r),
         XD.MultiScaleLogFreqDiscriminator(((512, 128), (256, 64)), channels=4)),
        ("cqt", JX.DiscriminatorCQT(24000, 256, 9, 24, filters=4, rngs=r),
         XD.DiscriminatorCQT(24000, 256, 9, 24, filters=4)),
        ("subband_cqt", JX.MultiScaleSubbandCQTDiscriminator(filters=4, rngs=r),
         XD.MultiScaleSubbandCQTDiscriminator(filters=4)),
    ]


def _flat(tree):
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


@pytest.mark.parametrize("which", [d[0] for d in _discs()])
def test_discriminators_match_jax(rng, which):
    """Logits and every feature map (channels-last, SAME padding with strides
    and dilation, the MPD's reflect pad for T not a multiple of the period)."""
    _, jm, tm = next(d for d in _discs() if d[0] == which)
    randomize(jm, seed=1)
    # the parameters: the log-frequency filterbank is a constant of both
    load_nnx_state(tm, nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
    w = (0.3 * rng.normal(size=(2, 4001))).astype(np.float32)
    got, ref = _flat(tm(t(w))), _flat(jm(jnp.asarray(w)))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        np.testing.assert_allclose(n(g), np.asarray(r), atol=TOL * max(1.0, np.abs(r).max()))


# -- criteria ----------------------------------------------------------------------


def test_reconstruction_losses_and_their_gradients_match_jax(rng):
    from speechflow_tpu.models.vocoder import criterion as JC

    fake, real = ((0.2 * rng.normal(size=(2, 6000))).astype(np.float32) for _ in range(2))
    # the STFT loss's log(|X| + 1e-5) multiplies the two FFTs' rounding by up to 1e5 in
    # bins of tiny magnitude (measured 8e-5 of its scale at the first frames; its
    # spectral-convergence term alone agrees to 3e-7): 1e-3 of the scale there
    for tf, jf, tol in ((lambda f, r: mel_reconstruction_loss(f, r, n_mels=40),
                         lambda f, r: JC.mel_reconstruction_loss(f, r, n_mels=40), 1e-5),
                        (multires_stft_loss, JC.multires_stft_loss, 1e-3)):
        x = t(fake).requires_grad_()
        loss = tf(x, t(real))
        loss.backward()
        jl, jg = jax.value_and_grad(jf)(jnp.asarray(fake), jnp.asarray(real))
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
        np.testing.assert_allclose(n(x.grad), np.asarray(jg),
                                   atol=tol * np.abs(np.asarray(jg)).max(), rtol=0)


@pytest.mark.parametrize("step,ramp", [(0, 0), (5, 0), (5, 4), (8, 4)])
def test_gan_criteria_match_jax(rng, step, ramp):
    """Generator losses (adversarial gate and ramp on the micro-batch step) and
    their gradient with respect to the fake waveform; the discriminator's hinge."""
    from speechflow_tpu.models.vocoder import criterion as JC
    from speechflow_tpu.models.vocoder import discriminators as JD

    jd = randomize(JD.VocoderDiscriminator((2, 3), channels=4, use_cqt=True,
                                           rngs=nnx.Rngs(0)), seed=2)
    td = port(D.VocoderDiscriminator((2, 3), channels=4, use_cqt=True), jd)
    fake, real = ((0.2 * rng.normal(size=(2, 4096))).astype(np.float32) for _ in range(2))
    kw = dict(n_mels=40, adv_start_iter=5, adv_ramp_steps=ramp)
    tg, jg = vocoder_gen_criterion(**kw), JC.vocoder_gen_criterion(**kw)
    tgt, jtgt = {"waveform": t(real)}, {"waveform": jnp.asarray(real)}

    x = t(fake).requires_grad_()
    losses = tg(x, td, None, tgt, step)
    sum(losses.values()).backward()

    def jtotal(f):
        ls = jg(f, jd, None, jtgt, jnp.asarray(step, jnp.int32))
        return sum(ls.values()), ls

    (_, jl), jgrad = jax.value_and_grad(jtotal, has_aux=True)(jnp.asarray(fake))
    assert set(losses) == set(jl)
    for k in losses:
        np.testing.assert_allclose(losses[k].item(), float(jl[k]), rtol=1e-5, atol=1e-7)
    # the STFT term's log magnitudes set the tolerance, as above
    np.testing.assert_allclose(n(x.grad), np.asarray(jgrad),
                               atol=1e-3 * np.abs(np.asarray(jgrad)).max(), rtol=0)

    d = vocoder_disc_criterion()(t(fake), td, None, tgt, step)
    jdl = JC.vocoder_disc_criterion()(jnp.asarray(fake), jd, None, jtgt, step)
    np.testing.assert_allclose(d["disc_hinge"].item(), float(jdl["disc_hinge"]), rtol=1e-5)


def test_perceptual_terms_raise_until_ported(tmp_path):
    """Both perceptual terms are ported: the CPC term (``cpc_ckpt``, its parity:
    ``test_torch_cpc.py``) reads a CPC checkpoint; the speaker-similarity term (``bio_ckpt``, an ECAPA pickle) adds
    ``spk_sim`` (its parity: ``test_torch_vocoder_options.py``)."""
    from speechflow_torch.models.biometric.ecapa import ECAPAEmbedder, ECAPAParams
    from speechflow_torch.utils.state_io import save_module

    with pytest.raises(FileNotFoundError):
        vocoder_gen_criterion(cpc_ckpt="x", device="cpu")
    p = ECAPAParams(n_mels=20, channels=8, emb_dim=4, n_blocks=1)
    ckpt = save_module(ECAPAEmbedder(p), p, tmp_path / "ecapa.pkl")
    crit = vocoder_gen_criterion(n_mels=20, bio_ckpt=str(ckpt), device="cpu")
    wav = torch.randn(1, 2048, generator=torch.Generator().manual_seed(0)) * 0.3

    def disc(x):
        return [x.mean(-1, keepdim=True)], [[x]]

    losses = crit(wav, disc, None, {"waveform": wav}, 0)
    assert abs(float(losses["spk_sim"])) < 1e-5  # the same waveform: cosine 1
