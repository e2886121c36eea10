"""The vocoder options of the port against the JAX package (f32, CPU): the NSF
source and heads (``SineGen``, ``AdaIN``, ``NSFHiFiGANHead``, ``NSFiSTFTHead``,
with JAX's noise draws injected), the MDCT heads, the codec-decoder head, the
codec feature extractor (trained and frozen), the dummy backbone, ``Vocos``
with each option, both GAN criteria with ``ft_losses`` and the
speaker-similarity loss, and the vocoder interface's NSF paths.

Tolerance: every waveform within 1e-4 of the reference's largest magnitude
(``TOL_REL``); the sine source's phase is a float32 cumulative sum, which both
packages take over at most a few hundred samples here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.convert import flatten_nnx, nnx_from_module
from speechflow_torch.models.vocoder import Vocos, VocosParams
from tests.torch_parity import n, port, randomize, t

torch.set_num_threads(1)
TOL_REL = 1e-4
SR = 24000


def close(got, ref, tol: float = TOL_REL):
    got, ref = n(got), n(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max()
    assert err <= tol * scale, f"{err} > {tol} x {scale}"


def sine_draws(jax_head, b: int, s: int):
    """The two normals the JAX head's next ``SineGen`` call draws: one key of a
    clone of its rng stream, used for both shapes."""
    sg = nnx.clone(jax_head).sine_gen
    key = sg.rngs.params()
    return (t(jax.random.normal(key, (b, s, sg.n_harmonics))),
            t(jax.random.normal(key, (b, s, 1))))


def f0_frames(rng, b: int, frames: int) -> np.ndarray:
    """Voiced stretches of 100-300 Hz with unvoiced (0) frames between."""
    f0 = rng.uniform(100.0, 300.0, (b, frames))
    f0[:, ::3] = 0.0
    return f0.astype(np.float32)


def test_sine_gen_and_adain(rng):
    from speechflow_torch.models.vocoder.nsf import AdaIN, SineGen
    from speechflow_tpu.models.vocoder import nsf as J

    f0 = f0_frames(rng, 2, 6)
    head = J.NSFiSTFTHead(8, 32, 8, style_dim=4, rngs=nnx.Rngs(0))
    draws = sine_draws(head, 2, 6 * 8)
    ref = head.sine_gen(jnp.asarray(f0), 8)
    close(SineGen()(t(f0), 8, noise=draws), ref)
    assert n(SineGen()(t(f0), 8, noise=draws)).shape == (2, 48, 9)

    ja = randomize(J.AdaIN(12, 6, rngs=nnx.Rngs(0)), seed=1)
    ta = port(AdaIN(12, 6), ja)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32) * 3 + 1
    style = rng.normal(size=(2, 6)).astype(np.float32)
    close(ta(t(x), t(style)), ja(jnp.asarray(x), jnp.asarray(style)))
    close(ta(t(x), None), ja(jnp.asarray(x), None))  # population std, 1e-5 on the std


@pytest.mark.parametrize("style", [True, False])
def test_nsf_hifigan_head(rng, style):
    from speechflow_torch.models.vocoder.nsf import NSFHiFiGANHead
    from speechflow_tpu.models.vocoder.nsf import NSFHiFiGANHead as J

    rates = (4, 2, 2)
    jm = randomize(J(16, rates, channels=16, style_dim=6, rngs=nnx.Rngs(0)), seed=2)
    tm = port(NSFHiFiGANHead(16, rates, channels=16, style_dim=6), jm)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    f0 = f0_frames(rng, 2, 7)
    s = rng.normal(size=(2, 6)).astype(np.float32) if style else None
    draws = sine_draws(jm, 2, 7 * 16)
    ref = jm(jnp.asarray(x), jnp.asarray(f0), None if s is None else jnp.asarray(s))
    got = tm(t(x), t(f0), None if s is None else t(s), noise=draws)
    assert got.shape == (2, 7 * 16)
    close(got, ref)


def test_nsf_istft_head(rng):
    from speechflow_torch.models.vocoder.nsf import NSFiSTFTHead
    from speechflow_tpu.models.vocoder.nsf import NSFiSTFTHead as J

    jm = randomize(J(16, 64, 16, style_dim=6, rngs=nnx.Rngs(0)), seed=3)
    tm = port(NSFiSTFTHead(16, 64, 16, style_dim=6), jm)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    f0 = f0_frames(rng, 2, 9)
    s = rng.normal(size=(2, 6)).astype(np.float32)
    draws = sine_draws(jm, 2, 9 * 16)
    ref = jm(jnp.asarray(x), jnp.asarray(f0), jnp.asarray(s))
    close(tm(t(x), t(f0), t(s), noise=draws), ref)


@pytest.mark.parametrize("kind", ["symexp", "cos"])
def test_imdct_heads(rng, kind):
    from speechflow_torch.models.vocoder import heads as H
    from speechflow_tpu.models.vocoder import heads as J

    name = {"symexp": "IMDCTSymExpHead", "cos": "IMDCTCosHead"}[kind]
    jm = randomize(getattr(J, name)(16, 32, rngs=nnx.Rngs(0)), seed=4)
    tm = port(getattr(H, name)(16, 32), jm)
    np.testing.assert_array_equal(n(tm.basis), np.asarray(jm.basis))  # numpy-built, bit for bit
    assert not tm.basis.requires_grad
    x = 0.5 * rng.normal(size=(2, 6, 16)).astype(np.float32)
    got = tm(t(x))
    assert got.shape == (2, 6 * 32)
    close(got, jm(jnp.asarray(x)))


def test_dac_head(rng):
    from speechflow_torch.models.vocoder.heads import DACHead, _factor_strides
    from speechflow_tpu.models.vocoder.heads import DACHead as J
    from speechflow_tpu.models.vocoder.heads import _factor_strides as jfs

    assert _factor_strides(256) == jfs(256) == (8, 8, 4)
    assert _factor_strides(120) == jfs(120)
    with pytest.raises(ValueError, match="cannot factor"):
        _factor_strides(11)
    cp = dict(channels=4, latent_dim=8)
    jm = randomize(J(16, 32, cp, rngs=nnx.Rngs(0)), seed=5)
    tm = port(DACHead(16, 32, cp), jm)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    close(tm(t(x)), jm(jnp.asarray(x)))
    with pytest.raises(ValueError, match="vocoder hop"):
        DACHead(16, 32, dict(cp, strides=(4, 4)))


@pytest.mark.parametrize("freeze", [False, True])
def test_codec_features(rng, freeze):
    from speechflow_torch.models.vocoder.feature_extractors import CodecFeatures
    from speechflow_tpu.models.vocoder.feature_extractors import CodecFeatures as J

    cp = dict(channels=4, latent_dim=8, strides=(4, 4), n_quantizers=2, codebook_size=16)
    jm = randomize(J(cp, freeze=freeze, rngs=nnx.Rngs(0)), seed=6)
    tm = port(CodecFeatures(cp, freeze=freeze), jm)
    wav = 0.3 * rng.normal(size=(2, 160)).astype(np.float32)
    ref, got = jm({"waveform": jnp.asarray(wav)}), tm({"waveform": t(wav)})
    if freeze:
        assert isinstance(got, torch.Tensor) and not got.requires_grad
        close(got, ref)
        return
    close(got[0], ref[0])
    assert set(got[1]) == {"codec_vq"}
    np.testing.assert_allclose(float(got[1]["codec_vq"].detach()), float(ref[1]["codec_vq"]),
                               rtol=1e-5)
    got[1]["codec_vq"].backward()
    assert tm.codec.enc_pre.weight.grad is not None


VOCOS_BASE = dict(sample_rate=SR, n_fft=64, hop_length=16, n_mels=12, dim=16, n_layers=1,
                  upsample_rates=[4, 2, 2], upsample_channels=16, style_dim=6, n_harmonics=4,
                  mdct_frame_len=16)
OPTIONS = {
    "nsf_hifigan": dict(head="nsf_hifigan"),
    "nsf_istft": dict(head="nsf_istft"),
    "imdct_symexp": dict(head="imdct_symexp"),
    "imdct_cos": dict(head="imdct_cos"),
    "dac": dict(head="dac", dac_codec_params=dict(channels=4, latent_dim=8)),
    "dummy_backbone": dict(backbone="dummy", head="imdct_cos", n_mels=16),
    "codec": dict(feature_extractor="codec", head="istft",
                  codec_params=dict(channels=4, latent_dim=8, strides=[4, 4], n_quantizers=2,
                                    codebook_size=16)),
    "codec_nsf": dict(feature_extractor="codec", head="nsf_hifigan",
                      codec_params=dict(channels=4, latent_dim=8, strides=[4, 4],
                                        n_quantizers=2, codebook_size=16)),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_vocos_with_each_option(rng, option):
    """Waveform (and F0, speaker/style embedding) in, waveform (and the
    extractor's losses) out, through ``Vocos.forward`` and ``from_features``."""
    from speechflow_tpu.models.vocoder import Vocos as J
    from speechflow_tpu.models.vocoder import VocosParams as JP

    params = dict(VOCOS_BASE, **OPTIONS[option])
    jm = randomize(J(JP.create(params), rngs=nnx.Rngs(0)), seed=7)
    tm = port(Vocos(VocosParams.create(params)), jm)
    # the mapping both ways: the port's tree is the JAX state's, leaf for leaf
    back = flatten_nnx(nnx_from_module(tm))
    ref = flatten_nnx(nnx.to_pure_dict(nnx.state(jm, nnx.Not(nnx.RngState))))
    assert set(back) == set(ref) and all(np.array_equal(back[k], ref[k]) for k in ref)
    wav = 0.3 * rng.normal(size=(2, 16 * 8)).astype(np.float32)
    inputs = {"waveform": wav, "speaker_emb": rng.normal(size=(2, 6)).astype(np.float32)}
    frames = 9 if tm.params.feature_extractor == "mel" else 8
    if tm.nsf_head:
        inputs["pitch"] = f0_frames(rng, 2, frames - 2)  # padded with zeros to the frames
    draws = sine_draws(jm.head, 2, frames * 16) if tm.nsf_head else None
    ref = jm({k: jnp.asarray(v) for k, v in inputs.items()})
    got = tm({k: t(v) for k, v in inputs.items()}, sine_noise=draws)
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and set(got[1]) == set(ref[1])
        for k in ref[1]:
            np.testing.assert_allclose(float(got[1][k].detach()), float(ref[1][k]), rtol=1e-5)
        got, ref = got[0], ref[0]
    assert got.shape == ref.shape == (2, (frames - 1) * 16)
    close(got, ref)

    feats = rng.normal(size=(2, 7, tm.feature_extractor.dim)).astype(np.float32)
    f0 = f0_frames(rng, 2, 7) if tm.nsf_head else None
    kw = dict(f0=None if f0 is None else jnp.asarray(f0), style=jnp.asarray(inputs["speaker_emb"]))
    draws = sine_draws(jm.head, 2, 7 * 16) if tm.nsf_head else None
    ref = jm.from_features(jnp.asarray(feats), **(kw if tm.nsf_head else {}))
    tkw = dict(f0=None if f0 is None else t(f0), style=t(inputs["speaker_emb"]),
               sine_noise=draws)
    close(tm.from_features(t(feats), **(tkw if tm.nsf_head else {})), ref)


def test_nsf_without_f0_raises_and_from_features_feeds_zeros(rng):
    params = dict(VOCOS_BASE, head="nsf_hifigan")
    tm = Vocos(VocosParams.create(params)).eval()
    with pytest.raises(ValueError, match="frame-level F0"):
        tm({"waveform": torch.zeros(1, 64)})
    feats = torch.from_numpy(rng.normal(size=(1, 5, 12)).astype(np.float32))
    draws = tm.head.sine_gen.draw(1, 5 * 16, "cpu", torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        n(tm.from_features(feats, sine_noise=draws)),
        n(tm.from_features(feats, f0=torch.zeros(1, 5), sine_noise=draws)))


def test_dummy_backbone():
    from speechflow_torch.models.vocoder.backbones import DummyBackbone

    x = torch.randn(2, 3, 5)
    b = DummyBackbone(5)
    assert b.dim == 5 and b(x, torch.randn(2, 4)) is x and not list(b.parameters())


def _ecapa_ckpt(tmp_path, rng):
    """A seeded ECAPA written by the JAX ``save_module``."""
    from speechflow_tpu.models.biometric import ECAPAEmbedder, ECAPAParams
    from speechflow_tpu.utils.state_io import save_module

    p = ECAPAParams(n_mels=20, channels=16, emb_dim=8, n_blocks=2)
    m = randomize(ECAPAEmbedder(p, rngs=nnx.Rngs(0)), seed=8)
    return save_module(m, p, tmp_path / "ecapa.pkl")


def test_gan_criteria_with_ft_losses_and_speaker_similarity(rng, tmp_path):
    """``(wav, ft_losses)`` generator outputs: the generator criterion merges the
    losses and judges the waveform, the discriminator criterion judges the
    waveform alone; ``bio_ckpt`` adds ``spk_sim`` (JAX's ECAPA pickle, the port's
    loader), its gradient through the fake side only."""
    from speechflow_torch.models.vocoder.criterion import (
        vocoder_disc_criterion,
        vocoder_gen_criterion,
    )
    from speechflow_torch.models.vocoder.discriminators import VocoderDiscriminator
    from speechflow_tpu.models.vocoder import criterion as JC
    from speechflow_tpu.models.vocoder.discriminators import VocoderDiscriminator as JD

    ckpt = _ecapa_ckpt(tmp_path, rng)
    disc_kw = dict(periods=[2, 3], resolutions=[[256, 64]], channels=4)
    jd = randomize(JD(**disc_kw, rngs=nnx.Rngs(1)), seed=9)
    td = port(VocoderDiscriminator(**disc_kw), jd)
    fake = 0.3 * rng.normal(size=(2, 4096)).astype(np.float32)
    real = 0.3 * rng.normal(size=(2, 4100)).astype(np.float32)
    ft = {"ft_spectral": np.float32(1.25), "codec_vq": np.float32(0.5)}
    kw = dict(n_mels=20, bio_ckpt=str(ckpt), speaker_sim_weight=2.0, adv_start_iter=0)
    jl = JC.vocoder_gen_criterion(**kw)((jnp.asarray(fake), {k: jnp.asarray(v) for k, v in
                                                             ft.items()}),
                                        jd, None, {"waveform": jnp.asarray(real)},
                                        jnp.asarray(3))
    tf = t(fake).requires_grad_(True)
    tl = vocoder_gen_criterion(**kw, device="cpu")(
        (tf, {k: torch.tensor(v) for k, v in ft.items()}), td, None,
        {"waveform": t(real)}, 3)
    assert set(tl) == set(jl) == {"mel", "stft", "adv", "fm", "spk_sim", "ft_spectral",
                                  "codec_vq"}
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-4, err_msg=k)

    def jspk(f):
        return JC.make_speaker_similarity_loss(str(ckpt))(f, jnp.asarray(real[:, :4096]))

    jg = jax.grad(jspk)(jnp.asarray(fake))
    tl["spk_sim"].backward()
    close(tf.grad / 2.0, jg, 1e-3)  # a gradient through ECAPA's log-mel front-end

    d_ref = JC.vocoder_disc_criterion()((jnp.asarray(fake), {}), jd, None,
                                        {"waveform": jnp.asarray(real)}, 0)
    d_got = vocoder_disc_criterion()((t(fake), {"x": torch.tensor(1.0)}), td, None,
                                     {"waveform": t(real)}, 0)
    np.testing.assert_allclose(float(d_got["disc_hinge"]), float(d_ref["disc_hinge"]),
                               rtol=1e-5)
    with pytest.raises(FileNotFoundError):  # the CPC term is ported (test_torch_cpc.py)
        vocoder_gen_criterion(cpc_ckpt="x", device="cpu")


def test_vocoder_interface_nsf_paths(rng):
    """``synthesize`` with the F0 of a TTS output (its token pitch through the
    length-regulator attention) and ``resynthesize`` with the host's YIN F0,
    against the JAX model on the same F0 and draws."""
    from speechflow_torch.data.processors.np_dsp import yin_f0_np
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.models.tts.data_types import TTSOutput
    from speechflow_tpu.models.vocoder import Vocos as J
    from speechflow_tpu.models.vocoder import VocosParams as JP

    params = dict(VOCOS_BASE, head="nsf_hifigan", feature_extractor="mel")
    jm = randomize(J(JP.create(params), rngs=nnx.Rngs(0)), seed=10)
    vi = VocoderEvaluationInterface(port(Vocos(VocosParams.create(params)), jm))

    mel = rng.normal(size=(1, 8, 12)).astype(np.float32)
    attn = np.zeros((1, 8, 3), np.float32)
    attn[0, np.arange(8), [0, 0, 0, 1, 1, 2, 2, 2]] = 1.0
    pitch = np.asarray([[120.0, 0.0, 250.0]], np.float32)
    out = TTSOutput(spectrogram=t(mel)[None], attention=t(attn),
                    variance_predictions={"aggregate_pitch": t(pitch)})
    spk = rng.normal(size=(1, 6)).astype(np.float32)
    draws = sine_draws(jm.head, 1, 8 * 16)
    got = vi.synthesize(out, speaker_emb=spk, sine_noise=draws).data
    ref = jm.from_features(jnp.asarray(mel), cond=jnp.asarray(spk),
                           f0=jnp.einsum("btn,bn->bt", jnp.asarray(attn), jnp.asarray(pitch)),
                           style=jnp.asarray(spk))
    close(got, np.clip(np.asarray(ref)[0], -1, 1))

    wav = (0.4 * np.sin(2 * np.pi * 180 * np.arange(16 * 40) / SR)).astype(np.float32)
    f0 = yin_f0_np(wav, SR, 16, 2048, 80.0, 880.0, 0.2)
    draws = sine_draws(jm.head, 1, 41 * 16)
    got = vi.resynthesize(AudioChunk(data=wav, sr=SR), sine_noise=draws).data
    ref = jm({"waveform": jnp.asarray(wav)[None], "pitch": jnp.asarray(f0)[None]})
    assert got.shape == wav.shape
    close(got, np.clip(np.asarray(ref)[0], -1, 1))
