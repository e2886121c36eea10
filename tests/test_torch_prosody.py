"""The port's prosody model, its interface, criterion, targets, the WordLM
and ``train_prosody`` against the JAX package (CPU, f32), with JAX's weights
converted (``tests/torch_parity.py``) and the same seeded inputs."""

from pathlib import Path

import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.convert import flatten_nnx, nnx_from_module
from speechflow_torch.data import parsers as P
from speechflow_torch.data.processors import ling
from speechflow_torch.io.flist import construct_file_list
from speechflow_torch.io.seg import AudioSeg
from speechflow_torch.models.prosody import (
    ProsodyCriterion,
    ProsodyModel,
    ProsodyParams,
    ProsodyPredictionInterface,
    eer,
    hash_tokenize,
)
from speechflow_torch.models.prosody.lm import WordLM, train_token_lm, train_word_lm
from speechflow_torch.scripts import train_prosody
from speechflow_torch.training.optimizer import OptimizerConfig
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.training.trainer import Trainer, TrainerConfig
from tests.torch_parity import n, port, randomize, t

torch.set_num_threads(1)
LOGIT_TOL = 2e-5    # the prosody model's logits
STEP_TOL = 2e-4     # a Trainer step's update, of the largest update
LM_TOL = 1e-5       # the WordLM table after SGNS training (f32 rounding, 40 steps)
SMALL = dict(vocab_size=64, n_classes=8, dim=32, n_layers=2, n_heads=2, dropout=0.0)
WORDS = ("Hello world, this is a test. Printing, in the only sense with which we are at "
         "present concerned, differs from most if not from all the arts!").split()
SEGS = str(Path(__file__).resolve().parent / "data" / "SEGS")


def _pair(seed: int = 0, **kw):
    from speechflow_tpu.models.prosody import ProsodyModel as J
    from speechflow_tpu.models.prosody import ProsodyParams as JP

    cfg = dict(SMALL, **kw)
    jm = randomize(J(JP.create(cfg), rngs=nnx.Rngs(0)), seed)
    return jm, port(ProsodyModel(ProsodyParams.create(cfg)), jm), cfg


def _batch(rng, b: int = 3, tokens: int = 16, lengths=(16, 9, 1), vocab: int = 64):
    lens = np.asarray(lengths, np.int32)
    valid = np.arange(tokens)[None] < lens[:, None]
    ids = np.where(valid, rng.integers(1, vocab, (b, tokens)), 0).astype(np.int32)
    binary = np.where(valid, rng.integers(0, 2, (b, tokens)), -1).astype(np.int32)
    category = np.where(valid & (binary > 0), rng.integers(0, 8, (b, tokens)), -1)
    return {"token_ids": ids, "lengths": lens, "binary": binary,
            "category": category.astype(np.int32)}


def test_hash_tokenize_matches_jax():
    from speechflow_tpu.models.prosody.interface import hash_tokenize as jh

    for vocab in (8000, 64):
        np.testing.assert_array_equal(hash_tokenize(WORDS, vocab), jh(WORDS, vocab))


def test_prosody_model_logits_match_jax():
    jm, ours, _ = _pair()
    b = _batch(np.random.default_rng(0))
    ref = jm({"token_ids": b["token_ids"], "lengths": b["lengths"]}, training=False)
    got = ours({"token_ids": t(b["token_ids"]), "lengths": t(b["lengths"])})
    valid = np.arange(16)[None] < b["lengths"][:, None]
    for head in ("binary", "category"):  # valid words only: padded rows differ by design
        np.testing.assert_allclose(n(got[head])[valid], np.asarray(ref[head])[valid],
                                   atol=LOGIT_TOL, rtol=0, err_msg=head)


def test_warmstart_embeddings_matches_jax():
    """Both sides rescale the same WordLM table to the same current table."""
    jm, ours, _ = _pair(1)
    table = np.random.default_rng(2).normal(size=(40, 48)).astype(np.float32)
    jm.warmstart_embeddings(table)
    ours.warmstart_embeddings(table)
    np.testing.assert_allclose(n(ours.emb.weight), np.asarray(jm.emb.embedding[...]),
                               rtol=1e-6, atol=1e-7)


def _jax_checkpoint(tmp_path, jm, cfg, vocab=None):
    from speechflow_tpu.training import ExperimentSaver as JS

    saver = JS(tmp_path, expr_suffix="prosody")
    saver.to_save["model_params"] = dict(cfg)
    if vocab is not None:
        saver.to_save["word_lm_vocab"] = vocab
    saver.save(1, nnx.to_pure_dict(nnx.state(jm, nnx.Not(nnx.RngState))))
    return JS.get_last_checkpoint(saver.expr_path)


@pytest.mark.parametrize("tokenizer", ["hash", "word_lm"])
def test_interface_classes_match_jax(tmp_path, tokenizer):
    from speechflow_tpu.models.prosody.interface import ProsodyPredictionInterface as J
    from speechflow_tpu.training import ExperimentSaver as JS

    jm, _, cfg = _pair(3, n_classes=3)
    # no biases, and tokens that dominate the residual stream: classes that vary
    # from word to word
    for path, leaf in nnx.iter_graph(jm):
        if path and path[-1] == "bias":
            leaf[...] = leaf[...] * 0.0
    jm.emb.embedding[...] = jm.emb.embedding[...] * 10.0
    vocab = ({w.lower(): i + 1 for i, w in enumerate(sorted(set(WORDS[::2])))}
             if tokenizer == "word_lm" else None)
    ckpt = _jax_checkpoint(tmp_path, jm, cfg, vocab)
    ref = J(ckpt)
    ours = ProsodyPredictionInterface.from_checkpoint(*JS.load_checkpoint(ckpt), device="cpu")
    for words in (WORDS[:5], WORDS, WORDS[:1], WORDS[3:20]):
        a, b = ours.predict(words), ref.predict(words)
        for k in ("has_contour", "category"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    whole = ours.predict(WORDS)
    assert len(set(zip(whole["has_contour"], whole["category"]))) > 1
    assert ours.logits(WORDS)["binary"].shape == (1, 32, 2)


def test_criterion_and_eer_match_jax():
    from speechflow_tpu.models.prosody import ProsodyCriterion as J
    from speechflow_tpu.models.prosody.criterion import eer as jeer

    rng = np.random.default_rng(4)
    b = _batch(rng)
    outputs = {"binary": rng.normal(size=(3, 16, 2)).astype(np.float32),
               "category": rng.normal(size=(3, 16, 8)).astype(np.float32)}
    targets = {k: b[k] for k in ("binary", "category")}
    weights = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    for kw in ({}, {"binary_scale": 0.5, "category_scale": 2.0}):
        for cw in (None, weights):
            ref = J(class_weights=cw, **kw)(outputs, targets, 0)
            got = ProsodyCriterion(class_weights=None if cw is None else t(cw), **kw)(
                {k: t(v) for k, v in outputs.items()}, {k: t(v) for k, v in targets.items()}, 0)
            for k in ref:
                np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6)
    empty = {k: np.full_like(v, -1) for k, v in targets.items()}
    got = ProsodyCriterion()({k: t(v) for k, v in outputs.items()},
                             {k: t(v) for k, v in empty.items()}, 0)
    assert float(got["binary"]) == float(got["category"]) == 0.0
    scores, labels = rng.normal(size=50), rng.integers(0, 2, 50)
    assert eer(scores, labels) == jeer(scores, labels)
    assert eer(scores, np.ones(50)) == jeer(scores, np.ones(50)) == 0.0


def test_prosody_targets_and_parser_match_jax():
    from speechflow_tpu.data.parsers import ProsodyParser as JParser
    from speechflow_tpu.data.parsers import prosody_targets as jt

    cases = [(WORDS, None), (["a", "b", "c", "d", "e"], ["", "undefined", "no", "11", "x"])]
    for words, labels in cases:
        for k in (8, 3):
            for a, b in zip(P.prosody_targets(words, labels, k), jt(words, labels, k)):
                np.testing.assert_array_equal(a, b)
    files = construct_file_list(SEGS, ext=".TextGridStage3")
    vocab = {"the": 5, "of": 7}
    with_tier = 0
    for vocab_arg in (None, vocab):
        ours = P.ProsodyParser(vocab_size=100, vocab=vocab_arg)
        ref = JParser(vocab_size=100, vocab=vocab_arg)
        for f in files:
            a = ours.to_datasample(ours.reader(f)[0])
            b = ref.to_datasample(ref.reader(f)[0])
            assert a.words == b.words and a.label == b.label
            for k in ("token_ids", "binary", "category"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
            with_tier += P.seg_prosody_labels(AudioSeg.load(f), len(a.words)) is not None
    assert with_tier > 0
    samples = P.ProsodyParser().read_datasamples(files[:4])
    assert [s.index for s in samples] == [0, 1, 2, 3]


def _sentences(rng, n_sent: int = 40):
    pool = [f"w{i}" for i in range(30)] + ["The", "the", "a"]
    return [list(rng.choice(pool, rng.integers(3, 12))) for _ in range(n_sent)]


def test_train_token_lm_matches_jax():
    """The same seed gives JAX's table: the same draws in the same order, the
    SGNS step's gradients summed over repeated ids (``LM_TOL`` after 40 SGD
    steps of f32 rounding)."""
    from speechflow_tpu.models.prosody.lm import train_token_lm as jt
    from speechflow_tpu.models.prosody.lm import train_word_lm as jw

    sents = _sentences(np.random.default_rng(5))
    kw = dict(dim=16, window=2, epochs=5, batch_size=64, lr=0.1, seed=3, n_negatives=4)
    ours, ref = train_token_lm(sents, device="cpu", **kw), jt(sents, **kw)
    assert ours.vocab == ref.vocab
    assert np.abs(ref.embeddings).max() > 0.1
    np.testing.assert_allclose(ours.embeddings, ref.embeddings, atol=LM_TOL, rtol=0)
    texts = [" ".join(s) + "." for s in sents[:10]]
    a, b = train_word_lm(texts, device="cpu", dim=8, epochs=2), jw(texts, dim=8, epochs=2)
    np.testing.assert_allclose(a.embeddings, b.embeddings, atol=LM_TOL, rtol=0)


def test_word_lm_pickles_and_lm_features_match_jax(tmp_path, monkeypatch):
    """``WordLM.load`` of a JAX pickle, then ``lm_feat_for_words`` and
    ``add_xpbert_feat`` with ``model_ckpt`` (wider and narrower tables than
    the feature width), against JAX's."""
    from speechflow_tpu.data.processors import ling as jling
    from speechflow_tpu.data.core.datasample import TTSDataSample as JSample
    from speechflow_tpu.models.prosody.lm import WordLM as JW

    from speechflow_torch.data.core.datasample import TTSDataSample

    monkeypatch.setattr(ling, "_WORD_LMS", {})
    rng = np.random.default_rng(6)
    words = ["hello", "world", "zebra", "Hello", "unseen", "a"]
    for dim in (48, 16):
        vocab = {"hello": 1, "world": 2, "a": 3}
        ref = JW(vocab, rng.normal(size=(4, dim)).astype(np.float32))
        path = str(ref.save(tmp_path / f"lm{dim}.pkl"))
        ours = WordLM.load(path)
        assert ours.vocab == vocab
        np.testing.assert_array_equal(ours.embed(words), ref.embed(words))
        np.testing.assert_array_equal(ours.token_ids(words), ref.token_ids(words))
        assert ours.similarity("hello", "zebra") == pytest.approx(ref.similarity("hello", "zebra"))
        np.testing.assert_array_equal(ling.lm_feat_for_words(words, model_ckpt=path),
                                      jling.lm_feat_for_words(words, model_ckpt=path))
        phonemes = ["HH", "AH0", "L", "OW1"]
        a = ling.add_xpbert_feat(TTSDataSample(phonemes=phonemes), model_ckpt=path)
        b = jling.add_xpbert_feat(JSample(phonemes=phonemes), model_ckpt=path)
        np.testing.assert_array_equal(a.xpbert_feat, b.xpbert_feat)
    back = JW.load(str(ours.save(tmp_path / "port.pkl")))
    np.testing.assert_array_equal(back.embeddings, ours.embeddings)


def test_train_prosody_step_matches_jax():
    """One step of the script's Trainer (the debug preset's model, dropout 0,
    the loader's first batch) against the JAX Trainer's: the losses, then an
    SGD step at lr 1 whose update agrees within ``STEP_TOL`` of the largest."""
    from speechflow_tpu.models.prosody import ProsodyCriterion as JC
    from speechflow_tpu.training import Trainer as JTrainer
    from speechflow_tpu.training.optimizer import OptimizerConfig as JOpt
    from speechflow_tpu.training.trainer import TrainerConfig as JCfg

    cfg = dict(train_prosody.configs("debug")[0]["model"], dropout=0.0, vocab_size=8000)
    jm, ours, _ = _pair(7, **cfg)
    batch = train_prosody.ProsodySampleLoader(SEGS, 8000, batch_size=4).next_batch()
    sgd = dict(method="sgd", lr=1.0, lr_schedule="ConstLR", betas=(0.0, 0.999))
    jt = JTrainer(jm, JC(), train_prosody.prosody_batch, JOpt.from_config(sgd),
                  JCfg(max_steps=2))
    tt = Trainer(ours, ProsodyCriterion(), train_prosody.prosody_batch,
                 OptimizerConfig.from_config(sgd), TrainerConfig(max_steps=2))
    before = flatten_nnx(nnx_from_module(ours))
    a, b = jt.training_step(batch), tt.training_step(batch)
    assert set(a) == set(b) == {"binary", "category", "total_loss"}
    for k in a:
        np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=1e-5, err_msg=k)
    got = flatten_nnx(nnx_from_module(ours))
    ref = flatten_nnx(nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
    scale = max(np.abs(ref[k] - before[k]).max() for k in ref)
    err = max(np.abs((got[k] - before[k]) - (ref[k] - before[k])).max() for k in ref)
    assert 0 < scale and err <= STEP_TOL * scale, (err, scale)


def test_debug_preset_trains_and_serves(tmp_path):
    """``train_prosody`` at the debug preset, 4 steps on the CPU: the WordLM
    beside the checkpoint, its vocabulary in the payload, the checkpoint
    through the interface."""
    exp = train_prosody.main(["-vs", "debug", "--device", "cpu", "--max_steps", "4",
                              "--experiment_dir", str(tmp_path), "--data_root", SEGS])
    ckpt = ExperimentSaver.get_last_checkpoint(exp)
    tree, payload = ExperimentSaver.load_checkpoint(ckpt)
    assert int(tree["step"]) == 4 and payload["model_params"]["tokenizer"] == "word_lm"
    lm = WordLM.load(f"{exp}/word_lm.pkl")
    assert payload["word_lm_vocab"] == lm.vocab and len(lm.vocab) > 100
    iface = ProsodyPredictionInterface(ckpt, device="cpu")
    pred = iface.predict(WORDS)
    assert pred["has_contour"].shape == pred["category"].shape == (len(WORDS),)
    assert iface.tokenize(["the", "qwzx"])[1] == 0 and iface.tokenize(["the"])[0] > 0


def test_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_prosody.main(["-vs", "debug", "--experiment_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ProsodyPredictionInterface(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_word_lm(["a b c"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ProsodyPredictionInterface.from_checkpoint({}, {})
    with pytest.raises(FileNotFoundError, match="missing.yml"):
        train_prosody.main(["-c", str(tmp_path / "missing.yml"), "--device", "cpu"])
