"""Vocoders of the port against the JAX package (f32, CPU): the Vocos
backbone (with and without speaker conditioning), the unfolded
``SnakeUpsampleHead`` at the debug dims of ``configs/vocoder_bigvgan.yml`` and
with a 3-branch MRF group (the shared stage-1 FIR), ``Vocos.from_features``
with its (T-1)·hop trim, the ``ISTFTHead``, and the ``configs/vocoder_model.yml``
debug model (log-mel features on the device, ISTFT head) waveform to
waveform."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.models.vocoder import Vocos, VocosParams
from speechflow_torch.models.vocoder.backbones import ConvNeXtBlock, VocosBackbone
from speechflow_torch.models.vocoder.heads import ResBlock, SnakeUpsampleHead
from speechflow_torch.ops import anti_alias as AA
from tests.torch_parity import n, port, randomize, t, vocoder_params

torch.set_num_threads(1)
TOL = 2e-5
WAVE_TOL = 1e-4  # a waveform after 4-6 upsampling stages of f32 convs


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_convnext_block_and_backbone(rng):
    from speechflow_tpu.models.vocoder import backbones as J

    x = _x(rng, 2, 15, 24)
    jb = randomize(J.ConvNeXtBlock(24, rngs=nnx.Rngs(0)))
    np.testing.assert_allclose(n(port(ConvNeXtBlock(24), jb)(t(x))), n(jb(jnp.asarray(x))),
                               atol=TOL)
    jm = randomize(J.VocosBackbone(24, 32, 3, rngs=nnx.Rngs(0)))
    tm = port(VocosBackbone(24, 32, 3), jm)
    np.testing.assert_allclose(n(tm(t(x))), n(jm(jnp.asarray(x))), atol=TOL)


@pytest.mark.parametrize("kernel_size,dilations", [(3, (1, 3, 5)), (7, (1, 3, 5)), (4, (1, 2))])
def test_resblock(rng, kernel_size, dilations):
    from speechflow_tpu.models.vocoder.heads import ResBlock as J

    jm = randomize(J(12, kernel_size, dilations, rngs=nnx.Rngs(0)))
    tm = port(ResBlock(12, kernel_size, dilations), jm)
    x = _x(rng, 2, 50, 12)
    ref = n(jm(jnp.asarray(x)))
    np.testing.assert_allclose(n(tm(t(x))), ref, atol=TOL)
    shared = AA.aa_upsample_fir(t(x), 12)  # the MRF group's shared stage 1
    np.testing.assert_allclose(n(tm(t(x), shared_stage1=shared)), ref, atol=TOL)


@pytest.mark.parametrize("case", ["debug_config", "mrf3"])
def test_snake_upsample_head(rng, case):
    from speechflow_torch.serving import VOCODER_BIGVGAN_PRESETS
    from speechflow_tpu.models.vocoder.heads import SnakeUpsampleHead as J

    if case == "debug_config":
        p = VOCODER_BIGVGAN_PRESETS["debug"]
        kw = dict(dim=p["dim"], upsample_rates=p["upsample_rates"],
                  channels=p["upsample_channels"],
                  resblock_kernel_sizes=p["resblock_kernel_sizes"])
        t_len = 6
    else:
        kw = dict(dim=16, upsample_rates=[4, 2], channels=24, resblock_kernel_sizes=[3, 7, 11])
        t_len = 9
    jm = randomize(J(**kw, rngs=nnx.Rngs(0)))
    tm = port(SnakeUpsampleHead(**kw), jm)
    x = _x(rng, 2, t_len, kw["dim"])
    ref = n(jm(jnp.asarray(x)))
    out = n(tm(t(x)))
    assert out.shape == ref.shape == (2, t_len * int(np.prod(kw["upsample_rates"])))
    np.testing.assert_allclose(out, ref, atol=WAVE_TOL)
    assert np.abs(out).max() > 1e-3  # a signal, not zeros


def test_vocos_from_features(rng):
    from speechflow_tpu.models.vocoder import Vocos as J
    from speechflow_tpu.models.vocoder import VocosParams as JP

    params = vocoder_params()
    jm = randomize(J(JP.create(params), rngs=nnx.Rngs(1)))
    tm = port(Vocos(VocosParams.create(params)), jm)
    mel = _x(rng, 2, 5, 10)
    ref = n(jm.from_features(jnp.asarray(mel)))
    out = n(tm.from_features(t(mel)))
    assert out.shape == ref.shape == (2, 4 * 16)
    np.testing.assert_allclose(out, ref, atol=WAVE_TOL)
    # __call__ reads the feature from the inputs and gives the same waveform
    np.testing.assert_array_equal(n(tm({"mel": t(mel)})), out)


def test_unported_vocoder_options_raise():
    """Every option of the JAX ``Vocos`` builds (their parity is held in
    ``test_torch_vocoder_options.py``); an unknown one raises as JAX's does."""
    tts = dict(token_emb_dim=8, encoder_dim=8, encoder_layers=1, encoder_heads=2,
               decoder_type="wrapper", decoder_dim=8, decoder_layers=1, postnet_dim=8)
    for opt in (dict(feature_extractor="codec", head="istft", n_fft=64),
                dict(feature_extractor="tts", tts_params=tts),
                dict(head="nsf_hifigan"), dict(head="nsf_istft", n_fft=64),
                dict(head="imdct_symexp"), dict(head="imdct_cos"),
                dict(head="dac", dac_codec_params=dict(channels=4, latent_dim=8)),
                dict(backbone="dummy")):
        assert isinstance(Vocos(VocosParams.create(vocoder_params(**opt))), Vocos)
    for bad in (dict(feature_extractor="x"), dict(head="x"), dict(backbone="x")):
        with pytest.raises(ValueError):
            Vocos(VocosParams.create(vocoder_params(**bad)))


def test_istft_head(rng):
    from speechflow_torch.models.vocoder.heads import ISTFTHead
    from speechflow_tpu.models.vocoder.heads import ISTFTHead as J

    jm = randomize(J(24, 64, 16, rngs=nnx.Rngs(0)))
    bias = np.array(jm.out.bias[...])
    bias[0] = 12.0  # a magnitude above the clip at 10
    jm.out.bias[...] = jnp.asarray(bias)
    tm = port(ISTFTHead(24, 64, 16), jm)
    x = _x(rng, 2, 9, 24)
    ref = n(jm(jnp.asarray(x)))
    out = n(tm(t(x)))
    assert out.shape == ref.shape == (2, 8 * 16)
    np.testing.assert_allclose(out, ref, atol=TOL * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("cond", [False, True])
def test_vocoder_model_debug_waveform_to_waveform(rng, cond):
    """The debug model of ``configs/vocoder_model.yml`` (mel extractor, Vocos
    backbone, ISTFT head), and the same with ``cond_dim`` speaker
    conditioning: waveform -> log-mel -> waveform, N samples back for N a
    multiple of the hop."""
    from speechflow_torch.serving import VOCODER_MODEL_PRESETS
    from speechflow_tpu.models.vocoder import Vocos as J
    from speechflow_tpu.models.vocoder import VocosParams as JP

    params = VOCODER_MODEL_PRESETS["debug"]
    jm = J(JP.create(params), rngs=nnx.Rngs(1))
    if cond:
        # the JAX backbone cannot be built with cond_dim under the installed
        # flax (it assigns a Linear over the static ``cond_proj = None``); the
        # projection is attached as flax asks, and the JAX forward reads it
        jm.backbone.cond_proj = nnx.data(nnx.Linear(8, params["dim"], rngs=nnx.Rngs(2)))
        params = dict(params, cond_dim=8)
    jm = randomize(jm)
    tm = port(Vocos(VocosParams.create(params)), jm)
    wav = (0.3 * rng.normal(size=(2, 12 * 256))).astype(np.float32)
    inputs = {"waveform": wav}
    if cond:
        inputs["speaker_emb"] = _x(rng, 2, 8)
    ref = n(jm({k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.inference_mode():
        out = n(tm({k: t(v) for k, v in inputs.items()}))
        feats = n(tm.features({"waveform": t(wav)}))
    assert feats.shape == (2, 13, params["n_mels"])
    assert out.shape == ref.shape == wav.shape
    np.testing.assert_allclose(out, ref, atol=TOL * max(1.0, np.abs(ref).max()))
    assert np.abs(out).max() > 1e-3


def _follows_flax(ref: dict, got: dict) -> None:
    """Every tensor that is constant in the JAX module built from ``nnx.Rngs``
    (zero biases, log-scale snake α and β at 0, LayerNorm scales, the ConvNeXt
    ``gamma`` at its layer scale) is equal in the port's; every other tensor's
    standard deviation is within 6/sqrt(size) of the JAX one's (torch's
    kaiming-uniform would be 0.58 of it) and its mean within six standard
    errors of 0."""
    assert set(got) == set(ref)
    drawn = 0
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, k
        if r.size == 1 or (r == r.flat[0]).all():
            np.testing.assert_array_equal(g, r, err_msg=k)
            continue
        drawn += 1
        assert abs(g.std() / r.std() - 1) <= 6 / np.sqrt(r.size), k
        assert abs(g.mean()) <= 6 * g.std() / np.sqrt(r.size), k
    assert drawn >= len(ref) // 4


@pytest.mark.parametrize("case", ["bigvgan", "vocos_istft", "mpd_mrd", "cqt"])
def test_fresh_weights_follow_flax_initialisers(case):
    """A vocoder or discriminator built from its arguments starts from the JAX
    module's distribution (``layers.flax_init_``), not torch's."""
    from speechflow_torch.convert import flatten_nnx, nnx_from_module
    from speechflow_torch.models.vocoder.discriminators import VocoderDiscriminator
    from speechflow_tpu.models import vocoder as JV

    if case in ("bigvgan", "vocos_istft"):
        head = dict(head="snake_upsample", upsample_rates=[8, 8, 2, 2], upsample_channels=64,
                    resblock_kernel_sizes=[3, 7]) if case == "bigvgan" else dict(head="istft")
        p = vocoder_params(n_mels=80, dim=64, n_layers=2, **head)
        jm = JV.Vocos(JV.VocosParams.create(p), rngs=nnx.Rngs(0))
        torch.manual_seed(0)
        tm = Vocos(VocosParams.create(p))
    else:
        kw = dict(channels=8, use_cqt=case == "cqt")
        jm = JV.VocoderDiscriminator(**kw, rngs=nnx.Rngs(0))
        torch.manual_seed(0)
        tm = VocoderDiscriminator(**kw)
    _follows_flax(flatten_nnx(nnx.to_pure_dict(nnx.state(jm, nnx.Param))),
                  flatten_nnx(nnx_from_module(tm)))
