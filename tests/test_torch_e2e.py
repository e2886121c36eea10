"""Tokens -> waveform through the port's serving program against the JAX
package's ``e2e`` program (``am(...).spectrogram[-1]`` then
``vm.from_features``), f32 on the CPU at small dims: the same weights, the
same initial CFM noise, and predicted durations that must come out equal."""

import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch import serving
from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams
from speechflow_torch.models.vocoder import Vocos, VocosParams
from tests.torch_parity import (
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
    vocoder_params,
)

torch.set_num_threads(1)
WAVE_TOL = 2e-4  # acoustic model (MODEL_TOL) carried through the vocoder's tanh


def test_tokens_to_waveform_matches_jax(rng):
    from speechflow_tpu.models.vocoder import Vocos as JV
    from speechflow_tpu.models.vocoder import VocosParams as JVP

    ap = tts_params(max_output_length=40)
    vp = vocoder_params(n_mels=ap["n_mels"])
    jam = jax_tts_model(ap)
    jvm = randomize(JV(JVP.create(vp), rngs=nnx.Rngs(1)))
    am = port(ParallelTTSModel(ParallelTTSParams.create(ap)), jam)
    vm = port(Vocos(VocosParams.create(vp)), jvm)

    b, n_tok, t_out = 2, 11, ap["max_output_length"]
    arrays = tts_arrays(rng, b, n_tok, [n_tok, 7])
    noise = cfm_noise(jam, (b, t_out, ap["n_mels"]))
    ref_out = jam(jax_tts_input(arrays), training=False, t_out=t_out)
    ref_wav = n(jvm.from_features(ref_out.spectrogram[-1]))

    durs = n(am(torch_tts_input(arrays), t_out=t_out, noise=t(noise)).attention).sum(1)
    np.testing.assert_array_equal(durs, n(ref_out.attention).sum(1))
    assert durs.sum(1).max() < t_out
    wav = n(serving.synthesize(am, vm, torch_tts_input(arrays), t_out=t_out, noise=t(noise)))
    assert wav.shape == ref_wav.shape == (b, (t_out - 1) * vp["hop_length"])
    np.testing.assert_allclose(wav, ref_wav, atol=WAVE_TOL)
    assert np.abs(wav).max() > 1e-3


def test_debug_flagship_serves_on_cpu():
    """``build_flagship`` at the configs' debug dims, on the CPU (the plain
    versions of both kernels), answers a request batch made as the bench
    makes it: finite, non-silent, (t_out - 1)·hop samples."""
    am, vm = serving.build_flagship("debug", device="cpu", dtype=torch.float32, seed=0)
    assert am.p.encoder_dim == 64 and vm.params.upsample_channels == 16
    inputs = serving.bench_inputs(np.random.default_rng(0), batch=2, n_tokens=8, t_frames=24)
    wav = serving.synthesize(am, vm, inputs, t_out=24,
                             generator=torch.Generator().manual_seed(0))
    assert wav.shape == (2, 23 * 256)
    assert torch.isfinite(wav).all() and wav.std(dim=-1).min() > 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flagship_params_and_dtype(dtype):
    """The full-width flagship configuration is what the bench builds; its
    models take the requested dtype (weights only: nothing is run)."""
    tts_p, voc_p = serving.flagship_params("default")
    assert (tts_p.encoder_dim, tts_p.encoder_layers, tts_p.encoder_heads) == (768, 6, 6)
    assert (tts_p.decoder_type, tts_p.decoder_dim, tts_p.cfm_cfg_scale) == ("cfm", 768, 1.0)
    assert (tts_p.n_langs, tts_p.max_output_length, tts_p.dropout) == (2, 1024, 0.0)
    assert voc_p.feature_extractor == "audio" and voc_p.upsample_channels == 1536
    assert list(voc_p.upsample_rates) == [4, 4, 2, 2, 2, 2]
    am, vm = serving.build_flagship("debug", device="cpu", dtype=dtype, seed=1)
    assert {p.dtype for p in am.parameters()} == {dtype} == {p.dtype for p in vm.parameters()}
