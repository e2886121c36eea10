"""The port's denoisers against the JAX package (CPU, f32): the DEMUCS-class
``WaveDenoiser`` (with and without its GRU bottleneck, T not a multiple of
its total stride) and ``denoiser_criterion`` with its gradients, with JAX's
weights converted (``DEMUCS_TOL``; the STFT term's gradients
``STFT_GRAD_TOL``); ``save_module`` pickles across the
packages; the ``denoise`` handler's model and spectral-subtraction branches;
and the vocoder ``Denoiser`` (both modes) over a small snake-head vocoder
(``DENOISER_TOL``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.data.core.datasample import AudioDataSample as Sample
from speechflow_torch.data.processors import audio as A
from speechflow_torch.data.processors import get_handler
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.models.denoiser import WaveDenoiser, WaveDenoiserParams, denoiser_criterion
from speechflow_torch.models.vocoder import Vocos, VocosParams
from speechflow_torch.models.vocoder.denoiser import Denoiser
from speechflow_torch.utils.state_io import load_module, save_module
from tests.torch_parity import assert_grads_match, n, port, randomize, t, vocoder_params

torch.set_num_threads(1)
DEMUCS_TOL = 1e-5
DENOISER_TOL = 1e-5
# log(|X| + 1e-5) of the STFT loss turns FFT rounding into ~1.5e-4 of a gradient's
# scale (the L1 term alone agrees within DEMUCS_TOL)
STFT_GRAD_TOL = 1e-3
SMALL = dict(channels=4, depth=2, kernel_size=8, stride=4, growth=2.0)


def _jax_demucs(use_rnn: bool = True, seed: int = 0):
    from speechflow_tpu.models.denoiser import WaveDenoiser as J
    from speechflow_tpu.models.denoiser import WaveDenoiserParams as JP

    params = JP.create(dict(SMALL, use_rnn=use_rnn))
    return randomize(J(params, rngs=nnx.Rngs(0)), seed), params


def _noisy(seed: int, b: int, length: int):
    rng = np.random.default_rng(seed)
    tt = np.arange(length) / 24000
    clean = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400, (b, 1)) * tt)
    return ((clean + 0.05 * rng.normal(size=(b, length))).astype(np.float32),
            clean.astype(np.float32))


@pytest.mark.parametrize("use_rnn", [True, False])
def test_wave_denoiser_and_criterion_match_jax(use_rnn):
    from speechflow_tpu.models.denoiser import denoiser_criterion as jax_crit

    jm, _ = _jax_demucs(use_rnn)
    ours = port(WaveDenoiser(WaveDenoiserParams.create(dict(SMALL, use_rnn=use_rnn))), jm)
    noisy, clean = _noisy(0, 2, 1203)  # 1203 = 75·16 + 3: padded inside, cut after
    ref = np.asarray(jm(jnp.asarray(noisy)))
    got = ours(t(noisy))
    assert tuple(got.shape) == (2, 1203)
    np.testing.assert_allclose(n(got), ref, atol=DEMUCS_TOL * max(1.0, np.abs(ref).max()),
                               rtol=0)

    def jloss(m):
        out = jax_crit()(m(jnp.asarray(noisy)), {"clean": jnp.asarray(clean)}, 0)
        return sum(out.values()), out

    (ref_total, ref_parts), grads = nnx.value_and_grad(jloss, has_aux=True)(jm)
    parts = denoiser_criterion()(ours(t(noisy)), {"clean": t(clean)}, 0)
    assert list(parts) == list(ref_parts) == ["l1", "stft"]
    for k in parts:
        np.testing.assert_allclose(float(parts[k].detach()), float(ref_parts[k]),
                                   rtol=DEMUCS_TOL, err_msg=k)
    sum(parts.values()).backward()
    assert_grads_match(ours, grads, STFT_GRAD_TOL)
    for p in ours.parameters():
        p.grad = None
    l1_grads = nnx.grad(
        lambda m: jnp.mean(jnp.abs(m(jnp.asarray(noisy)) - jnp.asarray(clean))))(jm)
    torch.mean(torch.abs(ours(t(noisy)) - t(clean))).backward()
    assert_grads_match(ours, l1_grads, DEMUCS_TOL)


def test_demucs_checkpoints_cross_packages(tmp_path):
    from speechflow_tpu.models.denoiser import WaveDenoiser as J
    from speechflow_tpu.models.denoiser import WaveDenoiserParams as JP
    from speechflow_tpu.utils.state_io import load_module as jax_load
    from speechflow_tpu.utils.state_io import save_module as jax_save

    jm, jp = _jax_demucs()
    ours, params = load_module(WaveDenoiser, WaveDenoiserParams,
                               jax_save(jm, jp, tmp_path / "j.pkl"), device="cpu")
    noisy, _ = _noisy(1, 1, 640)
    ref = np.asarray(jm(jnp.asarray(noisy)))
    np.testing.assert_allclose(n(ours(t(noisy))), ref, atol=DEMUCS_TOL, rtol=0)
    back, _ = jax_load(J, JP, save_module(ours, params, tmp_path / "p.pkl"))
    np.testing.assert_array_equal(np.asarray(back(jnp.asarray(noisy))), ref)


@pytest.mark.parametrize("branch", ["model", "spectral"])
def test_denoise_handler_matches_jax(branch, tmp_path):
    from speechflow_tpu.data.core.datasample import AudioDataSample as JSample
    from speechflow_tpu.data.processors.audio import denoise as jax_denoise
    from speechflow_tpu.io import AudioChunk as JChunk
    from speechflow_tpu.utils.state_io import save_module as jax_save

    assert get_handler("denoise") is A.denoise
    noisy, _ = _noisy(2, 1, 9000)
    kw = dict(strength=0.7)
    if branch == "model":
        jm, jp = _jax_demucs()
        kw["model_ckpt"] = str(jax_save(jm, jp, tmp_path / "demucs.pkl"))
        A._DENOISERS[kw["model_ckpt"]] = load_module(WaveDenoiser, WaveDenoiserParams,
                                                     kw["model_ckpt"], device="cpu")[0]
    try:
        ref = jax_denoise(JSample(audio_chunk=JChunk(data=noisy[0], sr=24000)), **kw)
        got = A.denoise(Sample(audio_chunk=AudioChunk(data=noisy[0], sr=24000)), **kw)
    finally:
        A._DENOISERS.clear()
    ref, got = ref.audio_chunk.waveform, got.audio_chunk.waveform
    assert got.shape == ref.shape == (9000,) and got.dtype == np.float32
    if branch == "spectral":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=DEMUCS_TOL, rtol=0)
    assert np.abs(got - noisy[0]).max() > 1e-3  # it did something


@pytest.mark.parametrize("mode", ["zeros", "normal"])
def test_vocoder_denoiser_matches_jax(mode):
    from speechflow_tpu.models.vocoder import Vocos as J
    from speechflow_tpu.models.vocoder import VocosParams as JP
    from speechflow_tpu.models.vocoder.denoiser import Denoiser as JD

    params = vocoder_params()
    jm = randomize(J(JP.create(params), rngs=nnx.Rngs(1)))
    tm = port(Vocos(VocosParams.create(params)), jm)
    kw = dict(n_mels=10, n_fft=128, hop_length=32, mode=mode, bias_frames=40)
    jd, td = JD(jm, **kw), Denoiser(tm, **kw)
    ref_bias = np.asarray(jd.bias_spec)
    np.testing.assert_allclose(n(td.bias_spec), ref_bias,
                               atol=DENOISER_TOL * np.abs(ref_bias).max(), rtol=0)
    audio = n(tm.from_features(t(np.random.default_rng(3).normal(
        size=(2, 30, 10)).astype(np.float32))))
    for x in (audio, audio[0]):  # a batch and a single waveform
        ref = np.asarray(jd(jnp.asarray(x), strength=0.5))
        got = n(td(t(x), strength=0.5))
        assert got.shape == ref.shape == x.shape[:-1] + (x.shape[-1] // 32 * 32,)
        np.testing.assert_allclose(got, ref, atol=DENOISER_TOL * np.abs(ref).max(), rtol=0)
