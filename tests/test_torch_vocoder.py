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
    for bad in (dict(feature_extractor="codec"), dict(feature_extractor="tts"),
                dict(head="nsf_hifigan"), dict(head="nsf_istft"), dict(head="imdct_symexp"),
                dict(head="imdct_cos"), dict(head="dac"), dict(backbone="dummy")):
        with pytest.raises(NotImplementedError):
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
