"""The port's TTS eval interface against the JAX one (f32, CPU), from a
checkpoint the JAX ``ExperimentSaver`` wrote: a narrow flagship-shaped CFM
acoustic model with seeded weights (``tests/torch_parity.py``), the pipeline
info of ``configs/tts_data_24khz.yml`` with a speaker catalog, and a
``g2p.pkl`` beside it that both interfaces find. For plain multi-sentence
text and for SSML, ``prepare_batch`` must give identical inputs; ``evaluate``
with the JAX decoder's own noise equal integer durations, then the mel within
``MODEL_TOL``; ``cfm_timesteps`` is honoured; ``resynthesize`` of a corpus
utterance with and without a reference wav; what is still unported raises.

A second checkpoint holds the conditioned model (prosody classes, the
projected speaker embedding, the style VAE) beside a JAX prosody checkpoint:
``prosody_ckpt``, ``prepare_embeddings(ref_audio)`` (``EMB_TOL``),
``prepare_batch`` with prosody rows and the style mel, ``synthesize`` and
``resynthesize`` with the reference, each against the JAX interface."""

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch import serving
from speechflow_torch.data.processors import embeddings
from speechflow_torch.models.prosody import ProsodyPredictionInterface
from speechflow_torch.data.processors.text import TextParserHook
from speechflow_torch.interface.tts_interface import (
    TTSEvaluationInterface,
    TTSOptions,
)
from speechflow_torch.models.g2p import G2P
from speechflow_torch.utils.masks import sequence_mask
from tests.test_torch_g2p import CHARS, _jax_g2p
from tests.torch_parity import cfm_noise, jax_tts_model, n, randomize, t, tts_params

torch.set_num_threads(1)
MODEL_TOL = 2e-4  # the whole acoustic model in f32 (as test_torch_tts_model)
EMB_TOL = 1e-5    # the reference's speaker embedding and style mel
REPO = Path(__file__).resolve().parent.parent
REF_WAV = (REPO / "tests/data/SRC/EN/OPENSOURCE_VOICES/001_LJSpeech/LJSpeech-1.1/wavs/"
           "LJ001-0002.wav")
SEGA = REPO / "tests/data/SEGS/EN/LJSpeech/000/0.TextGridStage3"
LANGS = ("EN", "RU")
SPEAKERS = {"amy": 0, "bob": 1, "cyd": 2}
PLAIN = ("Hello world, a zebra dozed. Was it 3 bees?  Dr. Bob ate 2,000 deer; "
         "sure! ok")
SSML = 'hello <prosody rate="x-slow" pitch="+20%">zebra world</prosody> did, again'
OPTS = [TTSOptions(t_out=96), TTSOptions(t_out=96, pause_level="words", begin_pause=False),
        TTSOptions(t_out=96, pause_level="none", end_pause=False)]


def _symbols(g2p) -> list:
    """The G2P's phonemes and the char fallback's symbols."""
    return sorted(set(g2p.phoneme_inventory) | set(CHARS))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(checkpoint dir, JAX model): the model's state under ``model``, the
    payload a trainer stores, ``g2p.pkl`` in the experiment directory."""
    from speechflow_tpu.data.processors.text import Alphabet
    from speechflow_tpu.io import Config
    from speechflow_tpu.training import ExperimentSaver as JS

    params = tts_params(n_symbols=64)
    jm = jax_tts_model(params)
    saver = JS(tmp_path_factory.mktemp("tts"), expr_suffix="tts")
    g2p = _jax_g2p("gru", 2, 0.0)
    g2p.save(saver.expr_path / "g2p.pkl")
    cfg = Config.create_from_file(Path(__file__).parent.parent / "configs" /
                                  "tts_data_24khz.yml", value_select=["default"]).to_dict()
    rng = np.random.default_rng(4)
    saver.to_save["model_params"] = dict(params)
    saver.to_save["pipeline_info"] = {
        "config": cfg, "subsets": ["train", "test"],
        "alphabet": Alphabet(_symbols(g2p)).to_dict(),
        "singletons": {
            "SpeakerIDSetter": {"speaker2id": SPEAKERS, "lang2id": {"EN": 0, "RU": 1}},
            "DatasetStatistics": {"speaker_durations": {"amy": 1800.0, "bob": 9000.0,
                                                        "cyd": 30000.0}},
            "MeanBioEmbeddings": {"mean_emb": {"amy": rng.normal(size=6).tolist(),
                                               "bob": rng.normal(size=6).tolist()}},
        },
    }
    saver.save(3, nnx.to_pure_dict(nnx.state(jm, nnx.Not(nnx.RngState))))
    return JS.get_last_checkpoint(saver.expr_path)


@pytest.fixture(scope="module")
def interfaces(checkpoint):
    """(port interface, JAX interface) from the same checkpoint. The JAX
    pipeline's feature cache is off: it keys a sample by its file, and raw
    text samples have none, so every sentence would share one entry."""
    from speechflow_tpu.interface import TTSEvaluationInterface as J
    from speechflow_tpu.training import ExperimentSaver as JS

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SFTPU_DUMP_CACHE", raising=False)
        ref = J(checkpoint)
    ours = TTSEvaluationInterface.from_checkpoint(*JS.load_checkpoint(checkpoint),
                                                  ckpt_path=checkpoint, device="cpu")
    return ours, ref


def _jax_opts(opts):
    from speechflow_tpu.interface import TTSOptions as JO

    return JO(**dataclasses.asdict(opts))


def _assert_inputs_equal(ours, ref, skip=()):
    checked = []
    for f in dataclasses.fields(ours):
        if f.name in skip:
            continue
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        assert (a is None) == (b is None), f.name
        if isinstance(b, int):  # a setting (pad_id), not a batch field
            assert a == b, f.name
        elif a is not None:
            np.testing.assert_array_equal(n(a), np.asarray(b), err_msg=f.name)
            checked.append(f.name)
    return checked


def test_catalog_and_frontend(interfaces):
    ours, ref = interfaces
    assert isinstance(ours.text_processor.parser.g2p, G2P)
    assert ours.get_languages() == ref.get_languages() == list(LANGS)
    for hours in (None, 1.0, (0.4, 3.0), (3.0, 100.0)):
        assert ours.get_speakers(hours) == ref.get_speakers(hours)
    assert ours.get_speakers(1.0) == ["bob", "cyd"]
    assert ours.split_sentences(PLAIN) == ref.split_sentences(PLAIN)
    for w in ("Hello,", "zebra", "3", "Dr.", "...", "did!"):
        assert ours.prepare_text(w) == ref.prepare_text(w)
    words = PLAIN.split()
    for opts in OPTS:
        assert ours.predict_pauses(words, opts) == ref.predict_pauses(words,
                                                                 _jax_opts(opts))
    for speaker in (None, "amy", "cyd", "nobody"):
        a = ours.prepare_embeddings(ours.create_context("RU", speaker))
        b = ref.prepare_embeddings(ref.create_context("RU", speaker))
        assert (a.lang_id, a.speaker_id, a.speaker_name) == (b.lang_id, b.speaker_id,
                                                             b.speaker_name)
        assert (a.speaker_emb is None) == (b.speaker_emb is None)
        if a.speaker_emb is not None:
            np.testing.assert_array_equal(a.speaker_emb, b.speaker_emb)


MODIFIERS = ("pitch_modifier", "volume_modifier", "rate_modifier")


@pytest.mark.parametrize("opts", range(len(OPTS)))
@pytest.mark.parametrize("kind", ["plain", "ssml", "mixed"])
def test_prepare_batch_matches_jax(interfaces, kind, opts):
    """Identical inputs, but for the known divergence of a batch that mixes
    SSML and plain sentences: the JAX collate drops the SSML modifiers of
    the whole batch (ROADMAP §3), the port keeps them and gives the plain
    rows 1.0."""
    ours, ref = interfaces
    opts = OPTS[opts]
    sentences = {"plain": ours.split_sentences(PLAIN), "ssml": [SSML],
                 "mixed": [SSML, "A zebra."]}[kind]
    skip = MODIFIERS if kind == "mixed" else ()
    for speaker in ("bob", "amy"):
        a = ours.prepare_batch(sentences, ours.create_context("EN", speaker), opts)
        b = ref.prepare_batch(sentences, ref.create_context("EN", speaker), _jax_opts(opts))
        checked = _assert_inputs_equal(a, b, skip)
        expected = {"transcription", "transcription_lengths", "speaker_id", "lang_id",
                    "xpbert_feat"}
        if kind == "plain":
            expected |= {"ling_feat", "lm_feat"}
        if kind == "ssml":
            expected |= set(MODIFIERS)
        assert set(checked) == expected
    assert a.transcription.shape[1] % 16 == 0 and len(set(n(a.transcription_lengths))) > 1 \
        or kind != "plain"
    if kind == "ssml":
        rate = n(a.rate_modifier)[0]
        assert (rate == np.float32(0.6)).sum() == len(ours.prepare_text("zebra world"))
    if kind == "mixed":
        assert all(getattr(b, k) is None for k in MODIFIERS)
        alone = ours.prepare_batch([SSML], ours.create_context("EN", "amy"), opts)
        width = int(alone.transcription_lengths[0])
        for k in MODIFIERS:
            mixed = n(getattr(a, k))
            np.testing.assert_array_equal(mixed[0, :width], n(getattr(alone, k))[0, :width])
            np.testing.assert_array_equal(mixed[1], np.ones_like(mixed[1]))
        assert (n(a.rate_modifier)[0] == np.float32(0.6)).any()


def _evaluate_both(ours, ref, inputs_ours, inputs_ref, opts):
    b, t_out = inputs_ours.transcription.shape[0], opts.t_out
    noise = cfm_noise(ref.model, (b, t_out, ours.params.n_mels))
    out_ref = ref.evaluate(inputs_ref, _jax_opts(opts))
    out = ours.evaluate(inputs_ours, opts, noise=t(noise))
    return out, out_ref


def _assert_outputs_close(out, ref, t_out):
    durs, ref_durs = n(out.attention).sum(1), n(ref.attention).sum(1)
    np.testing.assert_array_equal(durs, ref_durs)  # integer durations first
    np.testing.assert_array_equal(n(out.spectrogram_lengths), n(ref.spectrogram_lengths))
    assert durs.sum(1).max() < t_out  # no frame cut off
    frames = n(sequence_mask(out.spectrogram_lengths, t_out)).astype(bool)
    for stage in range(2):
        np.testing.assert_allclose(n(out.spectrogram[stage])[frames],
                                   np.asarray(ref.spectrogram[stage])[frames],
                                   atol=MODEL_TOL, rtol=MODEL_TOL)


@pytest.mark.parametrize("cfm_timesteps", [None, 2])
@pytest.mark.parametrize("kind", ["plain", "ssml"])
def test_evaluate_matches_jax(interfaces, kind, cfm_timesteps):
    ours, ref = interfaces
    opts = TTSOptions(t_out=128, cfm_timesteps=cfm_timesteps)
    sentences = ours.split_sentences(PLAIN) if kind == "plain" else [SSML]
    a = ours.prepare_batch(sentences, ours.create_context("EN", "cyd"), opts)
    b = ref.prepare_batch(sentences, ref.create_context("EN", "cyd"), _jax_opts(opts))
    out, out_ref = _evaluate_both(ours, ref, a, b, opts)
    _assert_outputs_close(out, out_ref, opts.t_out)
    if cfm_timesteps is not None:  # fewer Euler steps: another mel from the same noise
        default = ours.evaluate(a, TTSOptions(t_out=128), noise=out.additional_content[
            "cfm_prior"].new_zeros(out.spectrogram[1].shape))
        steps = ours.evaluate(a, opts, noise=default.spectrogram[1].new_zeros(
            out.spectrogram[1].shape))
        assert (n(default.spectrogram[0]) != n(steps.spectrogram[0])).any()


def test_synthesize_matches_jax_and_ssml_rate_slows(interfaces):
    ours, ref = interfaces
    opts = TTSOptions(t_out=96)
    b = len(ours.split_sentences(PLAIN))
    noise = cfm_noise(ref.model, (b, 96, ours.params.n_mels))
    out_ref = ref.synthesize(PLAIN, lang="EN", speaker="bob", opts=_jax_opts(opts))
    out = ours.synthesize(PLAIN, lang="EN", speaker="bob", opts=opts, noise=t(noise))
    assert out.spectrogram.shape[1] == b == 6
    assert out.spectrogram_lengths.shape == (6,) and ours.get_speakers()[1] == "bob"
    _assert_outputs_close(out, out_ref, 96)
    gen = torch.Generator().manual_seed(0)
    slow = ours.synthesize(SSML, opts=opts, generator=gen)
    plain = ours.synthesize(SSML.replace('rate="x-slow" ', ""), opts=opts, generator=gen)
    assert int(slow.spectrogram_lengths.sum()) > int(plain.spectrogram_lengths.sum())


def test_char_fallback_matches_jax(checkpoint, interfaces):
    """Without a G2P both interfaces spell raw text as characters."""
    from speechflow_tpu.data.processors.text import TextParserHook as JH
    from speechflow_tpu.interface import TTSEvaluationInterface as J
    from speechflow_tpu.training import ExperimentSaver as JS

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SFTPU_DUMP_CACHE", raising=False)
        ref = J(checkpoint, text_parser=JH())
    tree, payload = JS.load_checkpoint(checkpoint)
    ours = TTSEvaluationInterface.from_checkpoint(tree, payload, device="cpu")
    assert type(ours.text_processor.parser) is TextParserHook  # nothing found: no ckpt_path
    ctx_a, ctx_b = ours.create_context("EN", "amy"), ref.create_context("EN", "amy")
    sentences = ours.split_sentences(PLAIN)
    _assert_inputs_equal(ours.prepare_batch(sentences, ctx_a, TTSOptions()),
                         ref.prepare_batch(sentences, ctx_b, _jax_opts(TTSOptions())))


def test_unported_paths_raise(checkpoint, interfaces, monkeypatch):
    """What is still unported raises: the HF wav2vec2 hook (its weights are not
    in the repository); and nothing runs on the GPU without CUDA (a prosody
    checkpoint, the ECAPA hook a reference wav would take, the CPC model behind
    an ``ssl_features`` checkpoint, ported since). The model options that raised
    until the acoustic-model kit was ported build from the same checkpoint: the
    average embeddings (none configured) and the classic condition named as
    sources give the same condition width."""
    from speechflow_tpu.training import ExperimentSaver as JS

    from speechflow_torch.data.core.datasample import AudioDataSample
    from speechflow_torch.io.audio import AudioChunk

    ours, _ = interfaces
    tree, payload = JS.load_checkpoint(checkpoint)
    for option, value in (("use_average_emb", True), ("condition_sources", ["speaker", "lang"])):
        other = dict(payload, model_params=dict(payload["model_params"], **{option: value}))
        built = TTSEvaluationInterface.from_checkpoint(tree, other, device="cpu")
        assert getattr(built.model.p, option) == (tuple(value) if isinstance(value, list)
                                                  else value)  # JAX's declared tuple
        assert built.model.cond_dim == ours.model.cond_dim
    monkeypatch.setattr(embeddings, "_MODELS", {})
    wav = AudioDataSample(audio_chunk=AudioChunk(data=np.zeros(4096, np.float32), sr=24000))
    with pytest.raises(NotImplementedError, match="wav2vec2"):
        embeddings.make_hf_wav2vec2_hook()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        embeddings.ssl_features(wav, model_ckpt="cpc.pkl")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTSEvaluationInterface.from_checkpoint(tree, payload)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ProsodyPredictionInterface(checkpoint)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        embeddings.voice_biometrics(wav, model_ckpt="ecapa.pkl")


def test_flagship_payload_builds_the_interface():
    """The payload ``chip_smoke.py`` serves the flagship from, on a narrow
    model: the text pipe of the data config, 16-token tiles, the catalog."""
    payload = serving.flagship_payload(list("abcdefghijklmnopqrstuvwxyz'"))
    model = serving.ParallelTTSModel(serving.ParallelTTSParams.create(
        tts_params(n_symbols=100, n_speakers=8)))
    iface = TTSEvaluationInterface(model, payload)
    assert iface.pipeline.handler_names == ["text_to_transcription", "add_xpbert_feat"]
    assert iface.get_speakers(4.5) == ["speaker_4", "speaker_5", "speaker_6", "speaker_7"]
    assert iface.get_languages() == ["EN", "RU"]
    x = iface.prepare_batch(["One sentence, here.", "And 2 more!"], iface.create_context(),
                            TTSOptions(t_out=64))
    assert x.transcription.shape == (2, 32) and x.xpbert_feat.shape == (2, 32, 32)
    out = iface.evaluate(x, TTSOptions(t_out=64), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out.spectrogram).all()
    with pytest.raises(ValueError, match="n_symbols"):
        serving.flagship_payload([chr(0x400 + i) for i in range(100)])


def test_resynthesize_matches_jax(interfaces):
    """A corpus utterance through the full pipeline (audio handlers included)
    and the model over its mel's frames, without and with a reference wav
    (whose speaker embedding the table-speaker model ignores; the style mel
    replaces the input mel after ``t_out`` is read from it)."""
    ours, ref = interfaces
    for ref_audio in (None, REF_WAV):
        _compare_resynthesis(ours, ref, ref_audio)


def _compare_resynthesis(ours, ref, ref_audio):
    probe = ours.resynthesize(SEGA, ref_audio=ref_audio,
                              generator=torch.Generator().manual_seed(0))
    t_out = probe.spectrogram.shape[2]
    assert t_out % 64 == 0 and t_out > 64  # the source mel, padded by the collate
    noise = cfm_noise(ref.model, (1, t_out, ours.params.n_mels))
    out_ref = ref.resynthesize(SEGA, ref_audio=ref_audio)
    out = ours.resynthesize(SEGA, ref_audio=ref_audio, noise=t(noise))
    assert out_ref.spectrogram.shape[2] == t_out
    _assert_outputs_close(out, out_ref, t_out)


# -- the conditioned model and its prosody model -------------------------------------

COND = dict(use_prosody=True, n_prosody_classes=6, speaker_emb_mode="input",
            speaker_bio_dim=192, use_style_encoder=True, style_emb_dim=8)
COND_MELS = 12  # the conditioned pipeline's linear_to_mel n_mels: the style mel's width
PROSODY = dict(vocab_size=64, n_classes=4, dim=32, n_layers=1, n_heads=2, dropout=0.0)


@pytest.fixture(scope="module")
def conditioned(tmp_path_factory):
    """(port interface, JAX interface) over a conditioned model, the mean speaker
    embeddings of its catalog, and a JAX prosody checkpoint whose classes vary
    from word to word (no biases, large token embeddings)."""
    from speechflow_tpu.data.processors.text import Alphabet
    from speechflow_tpu.data.processors.text import TextParserHook as JH
    from speechflow_tpu.interface import TTSEvaluationInterface as J
    from speechflow_tpu.io import Config
    from speechflow_tpu.models.prosody import ProsodyModel as JProsody
    from speechflow_tpu.models.prosody import ProsodyParams as JPP
    from speechflow_tpu.models.prosody.lm import WordLM as JWordLM
    from speechflow_tpu.training import ExperimentSaver as JS

    root = tmp_path_factory.mktemp("cond")
    pm = randomize(JProsody(JPP.create(PROSODY), rngs=nnx.Rngs(0)), 11)
    for path, leaf in nnx.iter_graph(pm):
        if path and path[-1] == "bias":
            leaf[...] = leaf[...] * 0.0
    pm.emb.embedding[...] = pm.emb.embedding[...] * 10.0
    psaver = JS(root / "prosody", expr_suffix="prosody")
    psaver.to_save["model_params"] = dict(PROSODY)
    psaver.save(1, nnx.to_pure_dict(nnx.state(pm, nnx.Not(nnx.RngState))))
    prosody_ckpt = JS.get_last_checkpoint(psaver.expr_path)

    params = tts_params(n_symbols=len(CHARS) + 8, n_mels=COND_MELS, **COND)
    jm = jax_tts_model(params)
    saver = JS(root / "tts", expr_suffix="tts")
    cfg = Config.create_from_file(REPO / "configs" / "tts_data_24khz.yml",
                                  value_select=["default"]).to_dict()
    cfg["preproc"]["pipe_cfg"]["linear_to_mel"]["n_mels"] = COND_MELS
    # a biometric checkpoint in the training pipe's config, which serving ignores, and a
    # WordLM for add_lm_feat, which resynthesis reads and raw text does not
    cfg["preproc"]["pipe_cfg"]["voice_biometrics"] = {"model_ckpt": str(root / "none.pkl")}
    rng = np.random.default_rng(9)
    words = sorted({w.lower() for w in PLAIN.split()})
    lm = JWordLM({w: i + 1 for i, w in enumerate(words)},
                 rng.normal(size=(len(words) + 1, 48)).astype(np.float32))
    cfg["preproc"]["pipe_cfg"]["add_lm_feat"] = {"model_ckpt": str(lm.save(root / "lm.pkl"))}
    saver.to_save["model_params"] = dict(params)
    saver.to_save["pipeline_info"] = {
        "config": cfg, "subsets": ["train", "test"],
        "alphabet": Alphabet(sorted(set(CHARS))).to_dict(),
        "singletons": {
            "SpeakerIDSetter": {"speaker2id": SPEAKERS, "lang2id": {"EN": 0, "RU": 1}},
            "MeanBioEmbeddings": {"mean_emb": {s: rng.normal(size=192).tolist()
                                               for s in SPEAKERS}},
        },
    }
    saver.save(3, nnx.to_pure_dict(nnx.state(jm, nnx.Not(nnx.RngState))))
    ckpt = JS.get_last_checkpoint(saver.expr_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SFTPU_DUMP_CACHE", raising=False)
        ref = J(ckpt, text_parser=JH(), prosody_ckpt=prosody_ckpt)
    prosody = ProsodyPredictionInterface.from_checkpoint(*JS.load_checkpoint(prosody_ckpt),
                                                         device="cpu")
    ours = TTSEvaluationInterface.from_checkpoint(*JS.load_checkpoint(ckpt), device="cpu",
                                                  prosody_ckpt=prosody)
    return ours, ref


@pytest.fixture
def no_biometric_hook(monkeypatch):
    from speechflow_tpu.data.processors import embeddings as JE

    monkeypatch.setattr(embeddings, "_MODELS", {})
    monkeypatch.setattr(JE, "_MODELS", {})


def test_prosody_ckpt_matches_jax(conditioned):
    ours, ref = conditioned
    words = PLAIN.split()
    a = ours.predict_prosody_by_text(words, ours.create_context())
    b = ref.predict_prosody_by_text(words, ref.create_context())
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.int32 and len(set(a)) > 1
    off = TTSOptions(use_prosody_model=False)
    np.testing.assert_array_equal(ours.predict_prosody_by_text(words, None, off),
                                  np.full(len(words), -1))


def test_prepare_embeddings_with_ref_audio_matches_jax(conditioned, no_biometric_hook):
    """The speaker embedding and the style mel of the reference wav. Serving
    calls ``voice_biometrics`` with its defaults, as the reference does: the
    pipe's ``model_ckpt`` is not read, and without a set hook the embedding is
    the handler's fallback (a train/serve skew of the reference, ROADMAP §3)."""
    from speechflow_torch.io.audio import AudioChunk

    ours, ref = conditioned
    a = ours.prepare_embeddings(ours.create_context("EN", "amy"), REF_WAV)
    b = ref.prepare_embeddings(ref.create_context("EN", "amy"), REF_WAV)
    assert a.speaker_emb.shape == (192,) and a.style_mel.shape[1] == COND_MELS
    np.testing.assert_allclose(a.speaker_emb, b.speaker_emb, atol=EMB_TOL, rtol=0)
    np.testing.assert_allclose(a.style_mel, b.style_mel, atol=EMB_TOL, rtol=0)
    wav = AudioChunk(file_path=REF_WAV).load(sr=24000)
    np.testing.assert_allclose(a.speaker_emb,
                               embeddings._fallback_embedding(wav.waveform, 24000), atol=1e-6)
    assert not np.allclose(a.speaker_emb, ours.mean_bio_embs["amy"])
    plain = ours.prepare_embeddings(ours.create_context("EN", "amy"))
    np.testing.assert_array_equal(plain.speaker_emb, ours.mean_bio_embs["amy"])
    assert plain.style_mel is None


def test_conditioned_prepare_batch_and_synthesize_match_jax(conditioned, no_biometric_hook):
    """Prosody rows, the reference's embedding on every row and its style mel
    broadcast over the batch: identical inputs; then ``synthesize`` with the
    JAX decoder's noise."""
    ours, ref = conditioned
    opts = TTSOptions(t_out=96)
    sentences = ours.split_sentences(PLAIN)
    ctx_a = ours.prepare_embeddings(ours.create_context("EN", "bob"), REF_WAV)
    ctx_b = ref.prepare_embeddings(ref.create_context("EN", "bob"), REF_WAV)
    a = ours.prepare_batch(sentences, ctx_a, opts)
    b = ref.prepare_batch(sentences, ctx_b, _jax_opts(opts))
    checked = _assert_inputs_equal(a, b, skip=("speaker_emb", "mel"))
    assert {"prosody", "mel_lengths"} <= set(checked)
    for name in ("speaker_emb", "mel"):
        np.testing.assert_allclose(n(getattr(a, name)), np.asarray(getattr(b, name)),
                                   atol=EMB_TOL, rtol=0, err_msg=name)
    pros = n(a.prosody)
    assert (pros[:, 0] == -1).all() and (pros >= 0).any() and a.mel.shape[0] == len(sentences)
    noise = cfm_noise(ref.model, (len(sentences), 96, COND_MELS))
    out_ref = ref.synthesize(PLAIN, lang="EN", speaker="bob", ref_audio=REF_WAV,
                             opts=_jax_opts(opts))
    out = ours.synthesize(PLAIN, lang="EN", speaker="bob", ref_audio=REF_WAV, opts=opts,
                          noise=t(noise))
    _assert_outputs_close(out, out_ref, 96)
    assert math.isfinite(float(out.spectrogram.abs().max()))


def test_raw_text_lm_features_ignore_the_pipe_word_lm(conditioned):
    """Raw text gets the hashed LM features even though the training pipe's
    ``add_lm_feat`` read a WordLM, as in the reference (ROADMAP §3)."""
    from speechflow_torch.data.processors.ling import lm_feat_for_words

    ours, _ = conditioned
    sent = "Hello world, a zebra dozed."
    x = ours.prepare_batch([sent], ours.create_context("EN", "amy"), TTSOptions())
    lm = n(x.lm_feat)[0]
    hashed = lm_feat_for_words(sent.split())
    trained = lm_feat_for_words(sent.split(), model_ckpt=ours._pipe_cfg("add_lm_feat")[
        "model_ckpt"])
    rows = [r for r in lm if np.abs(r).max() > 0]
    assert len(rows) > len(hashed)  # each word's row on each of its phonemes
    assert all(np.isclose(r, hashed, atol=1e-7).all(1).any() for r in rows)
    assert not any(np.isclose(r, trained, atol=1e-3).all(1).any() for r in rows)


def test_conditioned_resynthesize_matches_jax(conditioned, no_biometric_hook):
    ours, ref = conditioned
    _compare_resynthesis(ours, ref, REF_WAV)
