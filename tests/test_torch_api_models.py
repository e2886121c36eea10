"""The model-layer names and keywords this slice adds, against the JAX
package (f32, CPU): ``ParallelTTSModel.inference`` and the TTS interface
serving through it, ``ConvBlock(dilation=, causal=, activation=)``,
``VariancePredictor(activation_out=)``, ``RNNEncoder(dim=)``,
``GaussianMixtureVAE.sample_prior`` with JAX's draws injected,
``AudioFeatures(proj_dim=)``, the vocoder head's ``remat``, ``ComponentState``
and the batch processor's ``ranges_table``.

Tolerances: 1e-5 of the reference's scale (its largest magnitude) for a
block or a model in f32; 1e-6 for ``sample_prior`` and for gradients with
``remat`` on against off (JAX's keyword, which changes nothing in the port).
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.models.tts import common as C
from speechflow_torch.models.tts.model import ParallelTTSModel, ParallelTTSParams
from speechflow_torch.models.tts.predictors import GaussianMixtureVAE, VariancePredictor
from speechflow_torch.utils.masks import sequence_mask
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
)

torch.set_num_threads(1)
SCALE_TOL = 1e-5   # of the reference's largest magnitude, f32
DRAW_TOL = 1e-6

B, N, D = 2, 13, 32
LENS = np.array([N, 9])


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _close(out, ref, tol=SCALE_TOL, valid=None):
    out, ref = n(out), np.asarray(ref)
    assert out.shape == ref.shape
    if valid is not None:
        out, ref = out[valid], ref[valid]
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-12))


@pytest.mark.parametrize("activation", ["relu", "gelu", "tanh"])
@pytest.mark.parametrize("causal,dilation", [(False, 1), (True, 1), (False, 3), (True, 2)])
def test_conv_block_matches_jax(rng, activation, causal, dilation):
    from speechflow_tpu.models.tts import common as J

    x = rng.normal(size=(B, N, D)).astype(np.float32)
    jb = randomize(J.ConvBlock(D, 24, 5, dilation=dilation, causal=causal,
                               activation=activation, rngs=nnx.Rngs(0)))
    tb = port(C.ConvBlock(D, 24, 5, dilation=dilation, causal=causal, activation=activation),
              jb)
    _close(tb(t(x)), jb(jnp.asarray(x)))


def test_causal_conv_block_sees_no_future(rng):
    blk = C.ConvBlock(4, 4, 5, dilation=2, causal=True, dropout=0.0).eval()
    x = torch.from_numpy(rng.normal(size=(1, 12, 4)).astype(np.float32))
    y = x.clone()
    y[:, 7:] = 0.0
    torch.testing.assert_close(blk(x)[:, :7], blk(y)[:, :7], rtol=0, atol=0)


@pytest.mark.parametrize("activation_out", [None, "softplus", "relu"])
def test_variance_predictor_activation_out_matches_jax(rng, activation_out):
    from speechflow_tpu.models.tts import predictors as J

    x = rng.normal(size=(B, N, D)).astype(np.float32)
    jv = randomize(J.VariancePredictor(D, 24, 3, 5, activation_out=activation_out,
                                       rngs=nnx.Rngs(0)))
    tv = port(VariancePredictor(D, 24, 3, 5, activation_out=activation_out), jv)
    _close(tv(t(x), t(LENS)), jv(jnp.asarray(x), jnp.asarray(LENS)))


def test_rnn_encoder_takes_dim(rng):
    from speechflow_torch.models.tts.encoders import RNNEncoder
    from speechflow_tpu.models.tts import encoders as J

    x = rng.normal(size=(B, N, D)).astype(np.float32)
    je = randomize(J.RNNEncoder(D, 24, dim=64, rngs=nnx.Rngs(0)))
    te = port(RNNEncoder(D, 24, dim=64), je)
    valid = np.arange(N)[None] < LENS[:, None]
    _close(te(t(x), t(LENS)), je(jnp.asarray(x), jnp.asarray(LENS)), valid=valid)


@pytest.mark.parametrize("sigma", [1.0, 0.3])
def test_sample_prior_matches_jax_draws(sigma):
    from speechflow_tpu.models.tts import predictors as J

    jg = randomize(J.GaussianMixtureVAE(D, 8, 6, rngs=nnx.Rngs(0)))
    tg = port(GaussianMixtureVAE(D, 8, 6), jg)
    key = jax.random.PRNGKey(3)
    ref = jg.sample_prior(key, n=5, sigma_multiplier=sigma)
    k_key, n_key = jax.random.split(key)  # JAX's draws, as sample_prior makes them
    idx = np.array(jax.random.randint(k_key, (5,), 0, 6))
    noise = np.array(jax.random.normal(n_key, (5, 8)))
    out = tg.sample_prior(5, sigma, idx=torch.from_numpy(idx), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(n(out), np.asarray(ref), rtol=0, atol=DRAW_TOL)
    drawn = tg.sample_prior(4, sigma, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (4, 8) and torch.isfinite(drawn).all()


def test_parallel_tts_inference_matches_jax(rng):
    params = tts_params()
    jm = jax_tts_model(params)
    tm = port(ParallelTTSModel(ParallelTTSParams.create(params)), jm)
    tm.train()  # inference() infers whatever the module's mode
    arrays = tts_arrays(rng, B, N, LENS)
    t_out = params["max_output_length"]
    noise = cfm_noise(jm, (B, t_out, params["n_mels"]))
    ref = jm.inference(jax_tts_input(arrays), t_out=t_out, cfm_timesteps=3)
    out = tm.inference(torch_tts_input(arrays), t_out=t_out, cfm_timesteps=3, noise=t(noise))
    np.testing.assert_array_equal(n(out.attention).sum(1), np.asarray(ref.attention).sum(1))
    np.testing.assert_array_equal(n(out.spectrogram_lengths), np.asarray(ref.spectrogram_lengths))
    frames = n(sequence_mask(out.spectrogram_lengths, t_out)).astype(bool)
    for stage in range(2):
        _close(out.spectrogram[stage], ref.spectrogram[stage], valid=frames)
    _close(out.gate, ref.gate, valid=frames)


def test_tts_interface_serves_through_inference(monkeypatch):
    from speechflow_torch import serving
    from speechflow_torch.interface.tts_interface import TTSEvaluationInterface, TTSOptions

    calls = []
    real = ParallelTTSModel.inference

    def counted(self, *a, **kw):
        calls.append(kw["t_out"])
        return real(self, *a, **kw)

    monkeypatch.setattr(ParallelTTSModel, "inference", counted)
    torch.manual_seed(0)
    model = ParallelTTSModel(serving.flagship_params("debug")[0]).eval()
    ti = TTSEvaluationInterface(model, serving.flagship_payload(list("abcdefghij")))
    out = ti.synthesize("A bad cab.", opts=TTSOptions(t_out=32),
                        generator=torch.Generator().manual_seed(0))
    assert calls == [32] and out.spectrogram.shape[2] == 32
    assert torch.isfinite(out.spectrogram).all()


def test_unread_interface_fields_are_warned_of(caplog):
    """JAX's ``TTSOptions.max_tokens`` and ``TTSContext.prosody_classes``/``seed``
    are read by nothing there or here: the defaults pass quietly, a value warns."""
    from speechflow_torch.interface.tts_interface import TTSContext, TTSOptions
    from speechflow_tpu.interface import tts_interface as J

    for ours, ref in ((TTSOptions(), J.TTSOptions()), (TTSContext(), J.TTSContext())):
        assert {f.name for f in dataclasses.fields(ours)} >= \
            {f.name for f in dataclasses.fields(ref)}
    with caplog.at_level(logging.WARNING, logger="speechflow_torch"):
        TTSOptions(t_out=32)
        TTSContext(lang="EN")
        assert not caplog.records
        TTSOptions(max_tokens=64)
        TTSContext(seed=3)
        TTSContext(prosody_classes={})
    assert [r.getMessage().split(" ")[0] for r in caplog.records] == \
        ["TTSOptions.max_tokens", "TTSContext:", "TTSContext:"]


def _head(remat: bool):
    from speechflow_torch.models.vocoder.heads import SnakeUpsampleHead

    torch.manual_seed(0)
    head = SnakeUpsampleHead(16, (2, 2), channels=16, resblock_kernel_sizes=(3, 5),
                             taps=6, remat=remat)
    with torch.no_grad():
        for p in head.parameters():
            p.add_(0.1 * torch.randn_like(p))
    return head


def test_remat_gradients_equal_without(rng):
    x = torch.from_numpy(rng.normal(size=(2, 10, 16)).astype(np.float32))
    grads = []
    for remat in (True, False):
        head = _head(remat)
        xi = x.clone().requires_grad_(True)
        (head(xi) ** 2).sum().backward()
        grads.append([xi.grad] + [p.grad for p in head.parameters()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=DRAW_TOL * max(n(b).max(), 1e-12))
    with torch.no_grad():  # inference: nothing to recompute, the same waveform
        torch.testing.assert_close(_head(True)(x), _head(False)(x), rtol=0, atol=0)


def test_remat_head_gradients_match_jax(rng):
    from speechflow_torch.models.vocoder.heads import SnakeUpsampleHead
    from speechflow_tpu.models.vocoder import heads as J

    x = rng.normal(size=(2, 10, 16)).astype(np.float32)
    jh = randomize(J.SnakeUpsampleHead(16, (2, 2), channels=16, resblock_kernel_sizes=(3, 5),
                                       taps=6, remat=True, rngs=nnx.Rngs(0)))
    th = port(SnakeUpsampleHead(16, (2, 2), channels=16, resblock_kernel_sizes=(3, 5),
                                taps=6, remat=True), jh)
    ref = jax.grad(lambda v: jnp.sum(jh(v) ** 2))(jnp.asarray(x))
    xi = t(x).requires_grad_(True)
    (th(xi) ** 2).sum().backward()
    _close(xi.grad, ref)


def test_audio_features_proj_dim_matches_jax(rng):
    """JAX's ``AudioFeatures(proj_dim=)`` is its stream through an ``nnx.Linear``;
    flax refuses to build that module (``self.proj = None`` makes the attribute
    static before the Linear is assigned), so the reference is the Linear alone."""
    from speechflow_torch.models.vocoder.feature_extractors import AudioFeatures

    class _Proj(nnx.Module):
        def __init__(self):
            self.proj = nnx.Linear(10, 24, rngs=nnx.Rngs(0))

    mel = rng.normal(size=(B, 7, 10)).astype(np.float32)
    jp = randomize(_Proj())
    tf = port(AudioFeatures("mel", 10, proj_dim=24), jp)
    assert tf.dim == 24 and AudioFeatures("mel", 10).dim == 10
    _close(tf({"mel": t(mel)}), jp.proj(jnp.asarray(mel)))
    assert AudioFeatures("mel", 10)({"mel": t(mel)}) is not None


def test_component_state_matches_jax():
    from speechflow_torch.models.tts.data_types import ComponentState
    from speechflow_tpu.models.tts.data_types import ComponentState as J

    ours = ComponentState(content=torch.ones(1, 2, 3), embeddings={"spk": torch.zeros(1, 4)})
    ours = ours.add_content("pitch", torch.ones(1, 2)).add_loss("kl", torch.tensor(0.5))
    ref = J(content=jnp.ones((1, 2, 3)), embeddings={"spk": jnp.zeros((1, 4))})
    ref = ref.add_content("pitch", jnp.ones((1, 2))).add_loss("kl", jnp.asarray(0.5))
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    assert sorted(ours.additional_content) == sorted(ref.additional_content)
    assert float(ours.additional_losses["kl"]) == float(ref.additional_losses["kl"])
    assert ours.embedding("spk").shape == ref.embedding("spk").shape
    assert ours.embedding("none") is None and ref.embedding("none") is None


def test_batch_processor_ranges_table_matches_jax(rng):
    from speechflow_torch.data.collate import CollatedTTS
    from speechflow_torch.models.tts.batch_processor import TTSBatchProcessor
    from speechflow_tpu.data.collate import CollatedTTS as JC
    from speechflow_tpu.models.tts.batch_processor import TTSBatchProcessor as JP

    table = rng.normal(size=(3, 4, 4)).astype(np.float32)
    fields = dict(transcription=np.ones((2, 5), np.int32),
                  transcription_lengths=np.array([5, 3], np.int32),
                  speaker_id=np.array([2, -1]))
    ours, _ = TTSBatchProcessor(table)(CollatedTTS(**fields))
    ref, _ = JP(table)(JC(**fields))
    np.testing.assert_array_equal(n(ours.ranges), np.asarray(ref.ranges))
    assert ours.pad_id == ref.pad_id == 0
    assert TTSBatchProcessor()(CollatedTTS(**fields))[0].ranges is None
