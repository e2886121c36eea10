"""The port's vocoder eval interface against the JAX one (f32, CPU), from a
checkpoint the JAX ``ExperimentSaver`` wrote and the JAX loader read back:
a debug BigVGAN vocoder (``configs/vocoder_bigvgan.yml`` debug dims, log-mel
features, the folded head as served), saved in the plain layout and in the
GAN trainer's ``generator`` layout. ``synthesize`` and ``resynthesize`` must
agree within ``WAVE_TOL``. Also: legacy state layouts remapped as the JAX
saver remaps them, a ``state_io.save_module`` file read by the port's
``load_module``, and the audio container."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.convert import flatten_nnx
from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.models.tts import TTSOutput
from speechflow_torch.models.vocoder import Vocos, VocosParams
from speechflow_torch.models.vocoder.folded_head import FoldedSnakeHead
from speechflow_torch.serving import VOCODER_BIGVGAN_PRESETS
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.utils.state_io import load_module
from tests.torch_parity import n, randomize, t

torch.set_num_threads(1)
WAVE_TOL = 1e-4  # a waveform after four upsampling stages of f32 convs (as test_torch_vocoder)
PARAMS = VOCODER_BIGVGAN_PRESETS["debug"]  # mel features, rates 8·8·2·2, 16 channels


@pytest.fixture(scope="module")
def jax_vocoder():
    from speechflow_tpu.models.vocoder import Vocos as J
    from speechflow_tpu.models.vocoder import VocosParams as JP

    params = JP.create(PARAMS)
    return randomize(J(params, rngs=nnx.Rngs(0)), seed=7), params


def _pure(model):
    return nnx.to_pure_dict(nnx.state(model, nnx.Not(nnx.RngState)))


@pytest.fixture(scope="module")
def checkpoints(jax_vocoder, tmp_path_factory):
    """{layout: checkpoint dir}, written by the JAX saver as the trainers write
    them (``model_params`` in the payload)."""
    from speechflow_tpu.training import ExperimentSaver as JS

    model, params = jax_vocoder
    out = {}
    for layout in ("plain", "generator"):
        saver = JS(tmp_path_factory.mktemp(layout), expr_suffix=layout)
        saver.to_save["model_params"] = params.to_dict()
        state = _pure(model) if layout == "plain" else {"generator": _pure(model)}
        saver.save(3, state)
        out[layout] = saver.expr_path
    return out


def _mel(rng, frames=9):
    return rng.normal(size=(frames, PARAMS["n_mels"])).astype(np.float32) - 4.0


@pytest.mark.parametrize("layout", ["plain", "generator"])
def test_from_checkpoint_matches_the_jax_interface(rng, checkpoints, layout):
    from speechflow_tpu.interface.vocoder_interface import VocoderEvaluationInterface as J
    from speechflow_tpu.io import AudioChunk as JA
    from speechflow_tpu.training import ExperimentSaver as JS

    ckpt = ExperimentSaver.get_last_checkpoint(checkpoints[layout])
    assert ckpt == JS.get_last_checkpoint(checkpoints[layout]) and ckpt.name == "step_000000003"
    tree, payload = JS.load_checkpoint(ckpt)
    assert ExperimentSaver.load_payload(ckpt) == payload
    ref = J(ckpt)
    vi = VocoderEvaluationInterface.from_checkpoint(tree, payload, device="cpu")
    assert isinstance(vi.model.head, FoldedSnakeHead) and vi.sample_rate == 24000

    mel = _mel(rng)
    a, b = vi.synthesize(mel), ref.synthesize(mel)
    assert a.sr == b.sr and a.data.shape == b.data.shape == (8 * 256,)
    np.testing.assert_allclose(a.data, b.data, atol=WAVE_TOL)
    assert np.abs(a.data).max() > 1e-3
    out = TTSOutput(spectrogram=t(np.stack([mel - 1.0, mel])[:, None]))
    np.testing.assert_array_equal(vi.synthesize(out).data, a.data)  # the postnet mel

    wav = (0.3 * rng.normal(size=12 * 256)).astype(np.float32)
    a = vi.resynthesize(AudioChunk(data=wav, sr=24000))
    b = ref.resynthesize(JA(data=wav, sr=24000))
    assert len(a) == len(b) == len(wav)
    np.testing.assert_allclose(a.data, b.data, atol=WAVE_TOL)
    # a chunk at another rate is resampled first, as the JAX interface does
    a = vi.resynthesize(AudioChunk(data=wav[:2000], sr=16000))
    b = ref.resynthesize(JA(data=wav[:2000], sr=16000))
    np.testing.assert_allclose(a.data, b.data, atol=WAVE_TOL)


def test_unfolded_interface_and_batches(rng, checkpoints, jax_vocoder):
    from speechflow_tpu.training import ExperimentSaver as JS

    tree, payload = JS.load_checkpoint(ExperimentSaver.get_last_checkpoint(checkpoints["plain"]))
    folded = VocoderEvaluationInterface.from_checkpoint(tree, payload, device="cpu")
    plain = VocoderEvaluationInterface.from_checkpoint(tree, payload, fold_inference=False,
                                                       device="cpu")
    assert not isinstance(plain.model.head, FoldedSnakeHead)
    mels = np.stack([_mel(rng), _mel(rng)])
    a, b = folded.synthesize(mels), plain.synthesize(mels)
    assert a.data.shape == (2, 8 * 256)  # a batch stays a batch
    np.testing.assert_allclose(a.data, b.data, atol=WAVE_TOL)
    ref = np.clip(n(jax_vocoder[0].from_features(jnp.asarray(mels))), -1, 1)
    np.testing.assert_allclose(a.data, ref, atol=WAVE_TOL)


def test_legacy_layouts_are_remapped(rng, jax_vocoder):
    """A pre-MRF state (``resblocks.N`` a ResBlock) and an inline codec
    decoder migrate as the JAX saver migrates them; the remapped vocoder
    state loads and synthesizes as the current one."""
    from speechflow_tpu.training import ExperimentSaver as JS

    model, params = jax_vocoder
    pure = _pure(model)
    legacy = copy.deepcopy(pure)
    legacy["head"]["resblocks"] = {k: v[0] for k, v in legacy["head"]["resblocks"].items()}
    remapped = flatten_nnx(ExperimentSaver.remap_legacy_keys(copy.deepcopy(legacy)))
    ref = flatten_nnx(JS._remap_legacy_keys(copy.deepcopy(legacy)))
    assert remapped.keys() == ref.keys() == flatten_nnx(pure).keys()
    assert all(np.array_equal(remapped[k], ref[k]) for k in ref)
    codec = {"enc": {"w": 1}, "quantizer": {"q": 2}, "dec_pre": {"a": 3}, "dec": {"b": 4},
             "dec_post": {"c": 5}}
    assert ExperimentSaver.remap_legacy_keys(copy.deepcopy(codec)) == \
        JS._remap_legacy_keys(copy.deepcopy(codec))
    assert set(ExperimentSaver.remap_legacy_keys(copy.deepcopy(codec))) == \
        {"enc", "quantizer", "decoder"}
    payload = {"model_params": params.to_dict()}
    mel = _mel(rng)
    a = VocoderEvaluationInterface.from_checkpoint({"model": legacy}, payload, device="cpu")
    b = VocoderEvaluationInterface.from_checkpoint({"model": pure}, payload, device="cpu")
    np.testing.assert_array_equal(a.synthesize(mel).data, b.synthesize(mel).data)


def test_state_io_module_file(rng, jax_vocoder, tmp_path):
    from speechflow_tpu.utils.state_io import save_module

    model, params = jax_vocoder
    path = save_module(model, params, tmp_path / "vocoder.pkl")
    tm, tp = load_module(Vocos, VocosParams, path, device="cpu")
    assert tp.upsample_channels == PARAMS["upsample_channels"]
    mel = _mel(rng)[None]
    with torch.inference_mode():
        out = n(tm.from_features(t(mel)))
    np.testing.assert_allclose(out, n(model.from_features(jnp.asarray(mel))), atol=WAVE_TOL)


def test_audio_chunk(rng, tmp_path):
    from scipy.io import wavfile

    from speechflow_tpu.io import AudioChunk as JA

    wav = (0.3 * rng.normal(size=3000)).astype(np.float32)
    a, b = AudioChunk(data=wav, sr=22050).load(sr=24000), JA(data=wav, sr=22050).load(sr=24000)
    np.testing.assert_array_equal(a.waveform, b.waveform)
    assert len(a) == len(b) and a.duration == b.duration and a.sr == 24000
    pcm = (np.clip(np.stack([wav, -wav], 1), -1, 1) * 32767).astype(np.int16)
    wavfile.write(str(tmp_path / "x.wav"), 16000, pcm)
    a, b = AudioChunk(tmp_path / "x.wav"), JA(tmp_path / "x.wav")
    np.testing.assert_array_equal(a.load(sr=24000).waveform, b.load(sr=24000).waveform)
    assert a.duration == b.duration


@pytest.mark.parametrize("head", ["nsf_hifigan", "nsf_istft"])
def test_nsf_heads_raise(head):
    """The NSF heads are ported: the interface rebuilds one from a checkpoint's
    tree and synthesizes with an F0 (zeros without one); the NSF paths' parity is
    ``test_torch_vocoder_options.py::test_vocoder_interface_nsf_paths``."""
    from speechflow_torch.convert import nnx_from_module
    from speechflow_torch.models.vocoder import Vocos, VocosParams

    params = dict(PARAMS, head=head, n_fft=64, style_dim=8)
    tree = {"model": nnx_from_module(Vocos(VocosParams.create(params)))}
    vi = VocoderEvaluationInterface.from_checkpoint(tree, {"model_params": params},
                                                    device="cpu")
    mel = np.zeros((6, params.get("n_mels", 100)), np.float32)
    hop = vi.params.hop_length
    for f0 in (None, np.full(6, 150.0, np.float32)):
        out = vi.synthesize(mel, f0=f0).data
        assert out.shape == (5 * hop,) and np.isfinite(out).all()
    with pytest.raises(KeyError):  # the copy stays strict
        VocoderEvaluationInterface.from_checkpoint(
            {"model": {}}, {"model_params": params}, device="cpu")
