"""The port's speaker embedder and model-based feature handlers against the
JAX package (CPU, f32): the ECAPA embedder with JAX's weights converted
(masked and unmasked pooling, ``ECAPA_TOL``), single-module checkpoints
across the packages (``save_module`` / ``load_module``), ``make_ecapa_hook``
and ``make_codec_hook`` from JAX-written pickles, the handlers' fallbacks,
and the ``MeanBioEmbeddings`` singleton."""

import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.data.core.datasample import AudioDataSample as Sample
from speechflow_torch.data.processors import embeddings as E
from speechflow_torch.data.processors import get_handler
from speechflow_torch.data.processors.singletons import SINGLETON_HANDLERS, MeanBioEmbeddings
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.models.biometric import ECAPAEmbedder, ECAPAParams, triplet_loss
from speechflow_torch.utils.state_io import load_module, save_module
from tests.torch_parity import n, port, randomize, t

torch.set_num_threads(1)
ECAPA_TOL = 1e-5
SMALL = dict(n_mels=16, channels=32, emb_dim=24, n_blocks=2)
SR = 24000


def _jax_ecapa(seed: int = 0):
    from speechflow_tpu.models.biometric import ECAPAEmbedder as J
    from speechflow_tpu.models.biometric import ECAPAParams as JP

    params = JP.create(SMALL)
    model = randomize(J(params, rngs=nnx.Rngs(0)), seed)
    for blk in model.blocks:  # a gate far from flat, so that the squeeze shows
        for layer in (blk.se1, blk.se2):
            layer.kernel[...] = layer.kernel[...] * 8.0
    return model, params


def _wave(seed: int, seconds: float = 1.3) -> np.ndarray:
    """A voiced-like test signal: two harmonics with vibrato plus noise."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(SR * seconds)) / SR
    f0 = 140 + 25 * seed + 8 * np.sin(2 * np.pi * 3 * tt)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    wav = 0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase) + 0.02 * rng.normal(size=tt.size)
    return wav.astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_ecapa_matches_jax(masked):
    jm, _ = _jax_ecapa()
    ours = port(ECAPAEmbedder(ECAPAParams.create(SMALL)), jm)
    rng = np.random.default_rng(1)
    mel = rng.normal(size=(3, 50, 16)).astype(np.float32)
    lens = np.asarray([50, 31, 7], np.int32) if masked else None
    ref = np.asarray(jm(mel, None if lens is None else lens))
    got = n(ours(t(mel), None if lens is None else t(lens)))
    np.testing.assert_allclose(got, ref, atol=ECAPA_TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    if masked:  # the pooling masks, the squeeze does not: padding moves the embedding
        short = n(ours(t(mel[2:, :7]), t(lens[2:])))
        assert np.abs(short - got[2:]).max() > 1e-4


def test_triplet_loss_matches_jax():
    from speechflow_tpu.models.biometric.ecapa import triplet_loss as jl

    rng = np.random.default_rng(2)
    a, p, q = (rng.normal(size=(5, 8)).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(float(triplet_loss(t(a), t(p), t(q))),
                               float(jl(a, p, q)), rtol=1e-6)


def test_fresh_ecapa_follows_flax_initialisers():
    from speechflow_tpu.models.biometric import ECAPAEmbedder as J
    from speechflow_tpu.models.biometric import ECAPAParams as JP

    from speechflow_torch.convert import flatten_nnx, nnx_from_module

    ref = flatten_nnx(nnx.to_pure_dict(nnx.state(J(JP.create(SMALL), rngs=nnx.Rngs(0)),
                                                 nnx.Param)))
    torch.manual_seed(0)
    got = flatten_nnx(nnx_from_module(ECAPAEmbedder(ECAPAParams.create(SMALL))))
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if not r.any() or (r == 1).all():
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            assert abs(g.std() / r.std() - 1) <= 6 / np.sqrt(r.size), k


def test_module_pickles_load_in_both_packages(tmp_path):
    """A JAX ``save_module`` pickle through the port's ``load_module``, and the
    port's ``save_module`` pickle through JAX's ``load_module``."""
    from speechflow_tpu.models.biometric import ECAPAEmbedder as J
    from speechflow_tpu.models.biometric import ECAPAParams as JP
    from speechflow_tpu.utils.state_io import load_module as jax_load
    from speechflow_tpu.utils.state_io import save_module as jax_save

    jm, jp = _jax_ecapa(3)
    mel = np.random.default_rng(4).normal(size=(2, 40, 16)).astype(np.float32)
    lens = np.asarray([40, 22], np.int32)
    ours, params = load_module(ECAPAEmbedder, ECAPAParams, jax_save(jm, jp, tmp_path / "j.pkl"),
                               device="cpu")
    assert params == ECAPAParams.create(SMALL)
    np.testing.assert_allclose(n(ours(t(mel), t(lens))), np.asarray(jm(mel, lens)),
                               atol=ECAPA_TOL, rtol=0)
    torch.manual_seed(5)
    fresh = ECAPAEmbedder(ECAPAParams.create(SMALL))
    back, back_params = jax_load(J, JP, save_module(fresh, params, tmp_path / "p.pkl"))
    assert back_params == jp
    np.testing.assert_allclose(np.asarray(back(mel, lens)), n(fresh(t(mel), t(lens))),
                               atol=ECAPA_TOL, rtol=0)


def _both_samples(wav: np.ndarray):
    from speechflow_tpu.data.core.datasample import AudioDataSample as JSample
    from speechflow_tpu.io import AudioChunk as JChunk

    return (Sample(audio_chunk=AudioChunk(data=wav.copy(), sr=SR)),
            JSample(audio_chunk=JChunk(data=wav.copy(), sr=SR)))


@pytest.fixture
def no_hooks(monkeypatch):
    """Both packages' handler hooks empty for the test, restored after."""
    from speechflow_tpu.data.processors import embeddings as JE

    monkeypatch.setattr(E, "_MODELS", {})
    monkeypatch.setattr(JE, "_MODELS", {})
    return JE


def test_ecapa_hook_matches_jax(tmp_path, no_hooks):
    """``make_ecapa_hook`` over a JAX-written checkpoint, and ``voice_biometrics``
    with it as the model: the waveform padded to 64 hops, the unpadded frames
    as the pooling length, the same embedding. A handler's ``model_ckpt`` builds
    its hook on the GPU, so here (no CUDA) it raises; the CPU hook is set."""
    from speechflow_tpu.utils.state_io import save_module as jax_save

    JE = no_hooks
    jm, jp = _jax_ecapa(6)
    path = str(jax_save(jm, jp, tmp_path / "ecapa.pkl"))
    ours, ref = E.make_ecapa_hook(path, device="cpu"), JE.make_ecapa_hook(path)
    for seed, seconds in ((0, 1.3), (1, 0.4)):
        wav = _wave(seed, seconds)
        np.testing.assert_allclose(ours(wav, SR), ref(wav, SR), atol=ECAPA_TOL, rtol=0)
    a, b = _both_samples(_wave(2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.voice_biometrics(a, model_ckpt=path)
    E.set_biometric_model(ours)
    got = E.voice_biometrics(a, model_ckpt=path).speaker_emb
    want = JE.voice_biometrics(b, model_ckpt=path).speaker_emb
    assert got.dtype == np.float32 and got.shape == (SMALL["emb_dim"],)
    np.testing.assert_allclose(got, want, atol=ECAPA_TOL, rtol=0)
    E.set_biometric_model(lambda w, sr: np.ones(3))  # a hook wins over the checkpoint
    np.testing.assert_array_equal(E.voice_biometrics(a, model_ckpt=path).speaker_emb,
                                  np.ones(3, np.float32))
    E.set_biometric_model(None)


def test_handler_fallbacks_match_jax(no_hooks):
    JE = no_hooks
    for seed in (0, 3):
        a, b = _both_samples(_wave(seed))
        np.testing.assert_allclose(E.voice_biometrics(a).speaker_emb,
                                   JE.voice_biometrics(b).speaker_emb, atol=1e-6, rtol=0)
        np.testing.assert_allclose(E.voice_biometrics(a, emb_dim=64).speaker_emb,
                                   JE.voice_biometrics(b, emb_dim=64).speaker_emb,
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(E.speech_quality(a).speech_quality_emb,
                                   JE.speech_quality(b).speech_quality_emb, rtol=1e-6)
        np.testing.assert_allclose(E.ssl_features(a, hop_len=320).ssl_feat,
                                   JE.ssl_features(b, hop_len=320).ssl_feat, atol=1e-5)
        np.testing.assert_allclose(E.codec_features(a).ac_feat, JE.codec_features(b).ac_feat,
                                   atol=1e-5)
    assert get_handler("voice_biometrics") is E.voice_biometrics
    assert {"ssl_features", "speech_quality", "codec_features"} <= {
        h for h in ("ssl_features", "speech_quality", "codec_features") if get_handler(h)}


def test_codec_hook_matches_jax(tmp_path, no_hooks):
    """``codec_features`` through ``make_codec_hook`` over a JAX-written
    NeuralCodec: the quantised latents of the padded waveform, cut to its hops."""
    from speechflow_tpu.models.codec import CodecParams as JP
    from speechflow_tpu.models.codec import NeuralCodec as J
    from speechflow_tpu.utils.state_io import save_module as jax_save

    JE = no_hooks
    jp = JP.create(dict(channels=4, latent_dim=8, strides=(2, 4), n_quantizers=2,
                        codebook_size=16))
    path = str(jax_save(randomize(J(jp, rngs=nnx.Rngs(0)), 7), jp, tmp_path / "codec.pkl"))
    a, b = _both_samples(_wave(1, 0.3))
    E.set_codec_model(E.make_codec_hook(path, device="cpu"))
    got = E.codec_features(a, model_ckpt=path).ac_feat
    want = JE.codec_features(b, model_ckpt=path).ac_feat
    assert got.shape == want.shape == (len(_wave(1, 0.3)) // 8, 8)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_unported_hooks_raise():
    """The HF wav2vec2 hook is not ported (its weights are not in the
    repository); the CPC hook is (``test_torch_cpc.py``), and like the other
    hooks it loads its model on the GPU unless asked for the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.make_cpc_hook("cpc.pkl")
    with pytest.raises(FileNotFoundError):
        E.make_cpc_hook("cpc.pkl", device="cpu")
    with pytest.raises(NotImplementedError, match="weights"):
        E.make_hf_wav2vec2_hook()


def test_mean_bio_embeddings_matches_jax():
    from speechflow_tpu.data.processors.singletons import MeanBioEmbeddings as J

    rng = np.random.default_rng(8)
    samples = [Sample(speaker_name=s, speaker_emb=rng.normal(size=4).astype(np.float32))
               for s in ("a", "b", "a", None)]
    ref = J()
    ref.mean_emb = {}  # the JAX handler is a process-wide singleton: start it empty
    ours, ref = MeanBioEmbeddings().fit(samples), ref.fit(samples)
    assert ours.state_dict() == ref.state_dict()
    assert set(ours.mean_emb) == {"a", "b", "__all__"}
    loaded = SINGLETON_HANDLERS["MeanBioEmbeddings"]()
    loaded.load_state_dict(ref.state_dict())
    blank = loaded.apply(Sample(speaker_name="b"))
    np.testing.assert_allclose(blank.speaker_emb, ref.mean_emb["b"], rtol=1e-6)


def test_ecapa_hook_runs_on_the_gpu_unless_asked(tmp_path, monkeypatch):
    torch.manual_seed(0)
    path = save_module(ECAPAEmbedder(ECAPAParams.create(SMALL)), ECAPAParams.create(SMALL),
                       tmp_path / "e.pkl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.make_ecapa_hook(str(path))
    assert E.make_ecapa_hook(str(path), device="cpu")(_wave(0), SR).shape == (24,)
