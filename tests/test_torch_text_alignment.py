"""Text onto ASR timestamps (``speechflow_torch/annotator/text_alignment.py``)
against the JAX package's: ``word_similarity``, the banded ``nm_align`` and
``align_words`` over the repository's SRC transcripts (each text against its
``.whisper`` words) after seeded ASR-style corruption (deletions, typos,
inserted fillers, as ``tests/test_text_alignment.py`` corrupts them), one
utterance at a time and as one audiobook. Host Python on both sides: the
results are held equal, floats bit for bit."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from speechflow_torch.annotator import text_alignment as T

torch.set_num_threads(1)
SRC = Path(__file__).resolve().parent / "data" / "SRC"
FILLERS = ["uh", "um", "eh", "mm"]


def _corrupt(stamps, rate: float, rng):
    """Each word dropped, given a typo (a letter dropped and two swapped) or
    followed by a filler, each with probability ``rate / 3``."""
    out = []
    for w, b, e in stamps:
        r = rng.uniform()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3 and len(w) > 3:
            k = int(rng.integers(1, len(w) - 1))
            w = w[:k] + w[k + 1:]
            if len(w) > 3:
                k = int(rng.integers(0, len(w) - 1))
                w = w[:k] + w[k + 1] + w[k] + w[k + 2:]
        out.append([w, b, e])
        if r > 1 - rate / 3:
            out.append([FILLERS[int(rng.integers(0, len(FILLERS)))], e, e + 0.05])
    return out


def _corpus():
    """(reference words, ASR timestamps) of each of the 50 SRC utterances (EN and
    RU): the ``.txt`` beside the audio where there is one, else the ASR's text."""
    out = []
    for side in sorted(SRC.rglob("*.whisper")):
        asr = json.loads(side.read_text(encoding="utf-8"))
        txt = side.with_suffix(".txt")
        text = txt.read_text(encoding="utf-8") if txt.exists() else asr["text"]
        out.append((T.tokenize_text(text), asr["timestamps"]))
    return out


def test_word_similarity_matches_jax():
    from speechflow_tpu.annotator import text_alignment as J

    rng = np.random.default_rng(0)
    words = sorted({T.normalize_word(w) for ref, _ in _corpus() for w in ref})
    pairs = [("weather", "whether"), ("", "abc"), ("abc", "xyz"), ("same", "same")]
    pairs += [(words[i], words[j]) for i, j in rng.integers(0, len(words), (400, 2))]
    for a, b in pairs:
        assert T.word_similarity(a, b) == J.word_similarity(a, b), (a, b)
    assert [T.normalize_word(w) for w in ("Hello,", "don't", "--")] == \
        [J.normalize_word(w) for w in ("Hello,", "don't", "--")] == ["hello", "don't", ""]


@pytest.mark.parametrize("rate", [0.0, 0.15, 0.3])
def test_nm_align_and_align_words_match_jax(rate):
    """Every SRC utterance: the same matched pairs and the same (word, begin, end)."""
    from speechflow_tpu.annotator import text_alignment as J

    rng = np.random.default_rng(int(rate * 100))
    n_pairs = 0
    for ref, stamps in _corpus():
        asr = _corrupt(stamps, rate, rng)
        ref_n, asr_n = [T.normalize_word(w) for w in ref], [T.normalize_word(w[0]) for w in asr]
        pairs = T.nm_align(ref_n, asr_n)
        assert pairs == J.nm_align(ref_n, asr_n)
        n_pairs += len(pairs)
        total = stamps[-1][2] + 0.3
        assert T.align_words(ref, asr, total) == J.align_words(ref, asr, total)
    assert n_pairs > 500


def test_audiobook_alignment_matches_jax():
    """Twenty utterances as one timeline (0.3 s between them), 20% corrupted, with a
    narrow band; and the degenerate inputs (no ASR words, no anchor)."""
    from speechflow_tpu.annotator import text_alignment as J

    rng = np.random.default_rng(7)
    ref, stamps, ofs = [], [], 0.0
    for words, st in _corpus()[:20]:
        ref += words
        stamps += [[w, b + ofs, e + ofs] for w, b, e in st]
        ofs = stamps[-1][2] + 0.3
    asr = _corrupt(stamps, 0.2, rng)
    ref_n, asr_n = [T.normalize_word(w) for w in ref], [T.normalize_word(w[0]) for w in asr]
    assert T.nm_align(ref_n, asr_n, band=30) == J.nm_align(ref_n, asr_n, band=30)
    assert T.align_words(ref, asr, ofs) == J.align_words(ref, asr, ofs)
    assert T.align_words(ref[:5], [], 2.0) == J.align_words(ref[:5], [], 2.0)
    junk = [["zzzz", 0.1, 0.2], ["qqqq", 0.5, 0.9]]
    assert T.align_words(ref[:4], junk) == J.align_words(ref[:4], junk)
