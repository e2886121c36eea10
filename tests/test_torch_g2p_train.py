"""The port's G2P training against the JAX package (CPU): the lexicon miner
and the EM aligner equal on the corpus, ``phoneme_error_rate`` equal, the
tagger's loss gradients (``G2P_TOL`` of each tensor's scale) and a few AdamW
steps of both architectures with dropout off, ``g2p.pkl`` read across the
packages (the same phonemes), ``train_g2p_artifact`` and ``train_tts``'s G2P
guard writing ``g2p.pkl``."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechflow_torch.models.g2p import (
    G2P,
    align_lexicon,
    mine_g2p_lexicon,
    phoneme_error_rate,
    train_g2p,
)
from speechflow_torch.models.g2p.model import BOW, EOW, _Ensemble, init_tagger_params

torch.set_num_threads(1)
G2P_TOL = 1e-5
SEGS = Path(__file__).resolve().parent / "data" / "SEGS"


@pytest.fixture(scope="module")
def lexicon():
    from speechflow_tpu.models.g2p import mine_g2p_lexicon as jax_mine

    segs = sorted(SEGS.rglob("*.TextGrid*"))
    lex = mine_g2p_lexicon(segs)
    assert lex == jax_mine(segs) and len(lex) > 200
    return lex


def test_aligner_matches_jax(lexicon):
    from speechflow_tpu.models.g2p import align_lexicon as jax_align

    assert align_lexicon(lexicon) == jax_align(lexicon)
    assert align_lexicon(lexicon, iters=1, max_emit=1) == jax_align(lexicon, iters=1, max_emit=1)


def test_phoneme_error_rate_matches_jax():
    from speechflow_tpu.models.g2p import phoneme_error_rate as jax_per

    rng = np.random.default_rng(0)
    for _ in range(20):
        a = [str(x) for x in rng.integers(0, 4, rng.integers(0, 7))]
        b = [str(x) for x in rng.integers(0, 4, rng.integers(0, 7))]
        assert phoneme_error_rate(a, b) == jax_per(a, b)


def _batch(lexicon, arch: str, win: int = 7):
    """The trainer's full batch of the first 60 entries, built as both trainers
    build it: (x, y, mask, lang_ids, sizes)."""
    lex = lexicon[:60]
    aligns = align_lexicon(lex)
    chars = sorted({c for _, w, _ in lex for c in w})
    cvocab = {c: i for i, c in enumerate(chars + [BOW, EOW, "\0"])}
    lvocab = {lg: i for i, lg in enumerate(sorted({lg.upper() for lg, _, _ in lex}))}
    ids, rows, labels, words = {}, [], [], []
    for (lang, w, _), chunks in zip(lex, aligns):
        if chunks is None:
            continue
        padded = BOW * (win // 2) + w + EOW * (win // 2)
        seq = [ids.setdefault(ch, len(ids)) for ch in chunks]
        rows += [[cvocab[padded[i + k]] for k in range(win)] + [lvocab[lang.upper()]]
                 for i in range(len(w))]
        labels += seq
        words.append((lvocab[lang.upper()], w, seq))
    sizes = (len(cvocab), len(lvocab), len(ids))
    if arch == "mlp":
        return np.asarray(rows), np.asarray(labels), None, None, sizes
    length = max(len(w) for _, w, _ in words)
    x = np.full((len(words), length), cvocab[EOW])
    y = np.zeros((len(words), length), np.int64)
    mask = np.zeros((len(words), length), np.float32)
    for i, (_, w, seq) in enumerate(words):
        x[i, :len(w)] = [cvocab[c] for c in w]
        y[i, :len(w)], mask[i, :len(w)] = seq, 1.0
    return x, y, mask, np.asarray([lg for lg, _, _ in words]), sizes


@pytest.mark.parametrize("arch", ["gru", "mlp"])
def test_loss_gradients_and_adamw_steps_match_jax(arch, lexicon):
    """The label-smoothed loss and its gradients at JAX's initial parameters,
    then ``train_g2p`` for 3 steps (dropout off, 2 members) in both packages:
    each parameter within G2P_TOL plus what the first step's AdamW makes of the
    gradients' own rounding (3·lr·|u_port - u_jax|, u = g/(|g| + eps))."""
    from speechflow_tpu.models.g2p import model as J

    x, y, mask, lang_ids, (nc, nl, nch) = _batch(lexicon, arch)
    kw = dict(hidden=32, arch=arch, win=7)
    ls = 0.1

    def jax_loss(p):
        if arch == "gru":
            logp = jax.nn.log_softmax(J._gru_forward(p, jnp.asarray(x), jnp.asarray(lang_ids)))
            nll = -jnp.take_along_axis(logp, jnp.asarray(y)[..., None], -1)[..., 0]
            m = jnp.asarray(mask)
            return ((1 - ls) * (nll * m).sum() / m.sum()
                    - ls * (logp.mean(-1) * m).sum() / m.sum())
        logp = jax.nn.log_softmax(J._mlp_forward(p, jnp.asarray(x), 7))
        nll = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], -1).mean()
        return (1 - ls) * nll - ls * logp.mean()

    bounds = []
    for m in range(2):  # each member's initial parameters (seed 7 + 1000·m)
        params = init_tagger_params(np.random.default_rng(7 + 1000 * m), arch, nc, nl, nch,
                                    char_dim=24, hidden=32, win=7)
        ref_loss, ref_grads = jax.value_and_grad(jax_loss)({k: jnp.asarray(v)
                                                            for k, v in params.items()})
        tagger = _Ensemble([params], arch, 7)
        if arch == "gru":
            logp = torch.log_softmax(tagger(torch.as_tensor(x), torch.as_tensor(lang_ids))[0],
                                     -1)
            nll = -torch.gather(logp, -1, torch.as_tensor(y)[..., None])[..., 0]
            mk = torch.as_tensor(mask)
            loss = ((1 - ls) * (nll * mk).sum() / mk.sum()
                    - ls * (logp.mean(-1) * mk).sum() / mk.sum())
        else:
            logp = torch.log_softmax(tagger(torch.as_tensor(x))[0], -1)
            nll = -torch.gather(logp, -1, torch.as_tensor(y)[:, None]).mean()
            loss = (1 - ls) * nll - ls * logp.mean()
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=G2P_TOL)
        bound = {}
        for k, g in ref_grads.items():
            g, got = np.asarray(g), tagger.p[k].grad.numpy()[0]
            assert np.abs(got - g).max() <= G2P_TOL * max(np.abs(g).max(), 1e-30), k
            bound[k] = 3 * 3e-3 * np.abs(got / (np.abs(got) + 1e-8) - g / (np.abs(g) + 1e-8))
        bounds.append(bound)

    lex = lexicon[:60]
    ref = J.train_g2p(lex, steps=3, ensemble=2, dropout=0.0, seed=7, **kw)
    got = train_g2p(lex, steps=3, ensemble=2, dropout=0.0, seed=7, device="cpu", **kw)
    assert got.chunk_symbols == ref.chunk_symbols and got.cvocab == ref.cvocab
    np.testing.assert_array_equal(got.bigrams[1], ref.bigrams[1])
    for m, (pj, pp) in enumerate(zip(ref.params, got.params)):
        for k in pj:
            err = np.abs(pp[k] - np.asarray(pj[k]))
            assert (err <= G2P_TOL + bounds[m][k]).all(), (m, k, float(err.max()))


@pytest.mark.parametrize("arch", ["gru", "mlp"])
def test_g2p_pickles_cross_packages(arch, lexicon, tmp_path):
    from speechflow_tpu.models.g2p import G2P as JG2P
    from speechflow_tpu.models.g2p import train_g2p as jax_train

    words = ["hello", "speech", "zebra", "quickly", "a", "nonexistentword"]
    lex = lexicon[:80]
    ours = train_g2p(lex, steps=4, ensemble=2, hidden=16, arch=arch, device="cpu")
    back = JG2P.load(ours.save(tmp_path / "port.pkl"))
    assert back.predict(words, use_lexicon=False) == ours.predict(words, use_lexicon=False)
    assert back.lexicon == ours.lexicon and len(ours.lexicon) == len(lex)
    ref = jax_train(lex, steps=4, ensemble=1, hidden=16, arch=arch)
    ref.save(tmp_path / "jax.pkl")
    mine = G2P.load(tmp_path / "jax.pkl", device="cpu")
    assert mine.predict(words, use_lexicon=False) == ref.predict(words, use_lexicon=False)
    assert mine.predict(words) == ref.predict(words)


def test_train_g2p_artifact_and_the_tts_guard(tmp_path):
    """``train_g2p_artifact`` with a held-out share (JAX's split), and
    ``train_tts``'s guard at the debug preset: each writes a ``g2p.pkl`` that
    both packages load."""
    from speechflow_tpu.models.g2p import G2P as JG2P

    from speechflow_torch.scripts import train_g2p as TG
    from speechflow_torch.scripts import train_tts
    from speechflow_torch.training.saver import ExperimentSaver

    out = TG.train_g2p_artifact(SEGS, tmp_path / "a", steps=3, holdout=0.1, ensemble=1,
                                device="cpu")
    assert out == str(tmp_path / "a" / "g2p.pkl")
    g = G2P.load(out, device="cpu")
    assert len(g.lexicon) == len(JG2P.load(out).lexicon) > 200

    model_cfg, data_cfg = train_tts.configs("debug", data_root=SEGS)
    assert model_cfg["experiment"]["g2p_ensemble"] == 1
    model_cfg["experiment"]["g2p_steps"] = 4
    saver = ExperimentSaver(tmp_path / "exp")
    train_tts._train_g2p(model_cfg, data_cfg, saver, torch.device("cpu"))
    pkl = saver.expr_path / "g2p.pkl"
    assert pkl.exists()
    assert G2P.load(pkl, device="cpu").predict(["hello"]) == JG2P.load(pkl).predict(["hello"])
