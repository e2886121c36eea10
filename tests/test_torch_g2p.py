"""The port's G2P inference against the JAX package (CPU): a ``g2p.pkl``
written by the JAX ``G2P.save`` from seeded numpy parameters (window MLP and
bidirectional GRU, ensembles of 1 and 2, chunk bigrams decoded by argmax or
Viterbi) is loaded by the port; ``predict`` and ``G2PParserHook`` must give
the same phonemes as the JAX ones, exactly."""

import numpy as np
import pytest
import torch

from speechflow_torch.data.processors.text import G2PParserHook
from speechflow_torch.models.g2p import G2P

torch.set_num_threads(1)

CHARS = list("abcdefghijklmnopqrstuvwxyz'") + list("абвгдеж")
CHUNKS = [(), ("AH0",), ("B",), ("K", "S"), ("IY1",), ("T",), ("N",), ("EH1",), ("L",),
          ("OW0",), ("R",), ("S",), ("AA1",), ("D", "Z")]
LEXICON = {("EN", "hello"): ("HH", "AH0", "L", "OW1"), ("EN", "world"): ("W", "ER1", "L", "D"),
           ("RU", "да"): ("d", "a")}
WORDS = ["Hello", "world!", "zebra", "a", "xylophonic", "Quick-silver", "don't", "café",
         "supercalifragilistic", "bb", "Hello", "e2e", "ж", "да", ""]


def _jax_g2p(arch: str, members: int, bigram_weight: float):
    from speechflow_tpu.models.g2p import G2P as J

    rng = np.random.default_rng(11 + members)
    bow, eow, unk = "<", ">", "\0"
    cvocab = {c: i for i, c in enumerate(CHARS + [bow, eow, unk])}
    lvocab = {"EN": 0, "RU": 1}
    nc, nch, d = len(cvocab), len(CHUNKS), 8

    def mat(fan_in, *shape):
        return (rng.standard_normal(shape) * 2.0 / np.sqrt(fan_in)).astype(np.float32)

    def vec(m):
        return (0.1 * rng.standard_normal(m)).astype(np.float32)

    def params():
        p = {"ce": mat(1, nc, d), "le": mat(1, 2, d)}
        if arch == "gru":
            h = 6
            p.update(w1=mat(2 * h, 2 * h, 2 * h), b1=vec(2 * h), wo=mat(2 * h, 2 * h, nch),
                     bo=vec(nch))
            for side in ("f_", "b_"):
                for g in "zrn":
                    p.update({side + "W" + g: mat(d, d, h), side + "U" + g: mat(h, h, h),
                              side + "b" + g: vec(h)})
        else:
            p.update(w1=mat(8 * d, 8 * d, 16), b1=vec(16), w2=mat(16, 16, 16), b2=vec(16),
                     wo=mat(16, 16, nch), bo=vec(nch))
        return p

    ps = [params() for _ in range(members)]
    s = rng.uniform(0.1, 1, nch)
    tr = rng.uniform(0.1, 1, (nch, nch))
    bigrams = (np.log(s / s.sum()).astype(np.float32),
               np.log(tr / tr.sum(1, keepdims=True)).astype(np.float32))
    return J(cvocab, lvocab, CHUNKS, ps if members > 1 else ps[0], win=7, lexicon=LEXICON,
             bigrams=bigrams, bigram_weight=bigram_weight, arch=arch)


@pytest.mark.parametrize("bigram_weight", [0.0, 0.7])
@pytest.mark.parametrize("members", [1, 2])
@pytest.mark.parametrize("arch", ["mlp", "gru"])
def test_predict_matches_jax(tmp_path, arch, members, bigram_weight):
    jg = _jax_g2p(arch, members, bigram_weight)
    path = jg.save(tmp_path / "g2p.pkl")
    from speechflow_tpu.models.g2p import G2P as J

    ref = J.load(path)
    g2p = G2P.load(path, device="cpu")
    assert g2p.phoneme_inventory == ref.phoneme_inventory and len(g2p.members) == members
    for lang in ("EN", "ru"):
        for use_lexicon in (True, False):
            out = g2p.predict(WORDS, lang, use_lexicon=use_lexicon)
            assert out == ref.predict(WORDS, lang, use_lexicon=use_lexicon)
    # the tagger's outputs are not degenerate: OOV words get distinct pronunciations
    oov = g2p.predict(WORDS[2:10], "EN", use_lexicon=False)
    assert len(set(oov)) > 4 and all(isinstance(p, tuple) for p in oov)
    assert g2p.predict(["hello"])[0] == LEXICON[("EN", "hello")]


def test_parser_hook_matches_jax(tmp_path):
    from speechflow_tpu.data.processors.text import G2PParserHook as JH

    path = _jax_g2p("gru", 2, 0.0).save(tmp_path / "g2p.pkl")
    hook, ref = G2PParserHook(path, device="cpu"), JH(path)
    for s in ("Hello, world! On June 3rd, the zebra -- quick-silver; don't.",
              "...", "A b c 42 e.g. Dr. Who?"):
        assert hook(s, "EN") == ref(s, "EN")
    assert isinstance(G2PParserHook(hook.g2p).g2p, G2P)


def test_g2p_runs_on_the_gpu_unless_told(tmp_path, monkeypatch):
    path = _jax_g2p("mlp", 1, 0.0).save(tmp_path / "g2p.pkl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G2P.load(path)


@pytest.mark.parametrize("arch", ["gru", "mlp"])
def test_fresh_tagger_is_the_jax_trainers_init(arch):
    """``init_tagger_params`` gives the arrays the JAX trainer starts from: its
    ``train_g2p`` at 0 steps returns them untouched, bit for bit."""
    from speechflow_torch.models.g2p.model import init_tagger_params
    from speechflow_tpu.models.g2p.model import train_g2p

    lexicon = [("EN", "cat", ("K", "AE1", "T")), ("EN", "dog", ("D", "AO1", "G")),
               ("EN", "sit", ("S", "IH1", "T")), ("RU", "да", ("d", "a"))]
    ref = train_g2p(lexicon, steps=0, ensemble=1, arch=arch, seed=3, hidden=16,
                    gru_hidden=8)
    got = init_tagger_params(np.random.default_rng(3), arch, len(ref.cvocab), len(ref.lvocab),
                             len(ref.chunk_symbols), hidden=16, gru_hidden=8)
    want = ref.params
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
