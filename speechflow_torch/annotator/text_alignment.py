"""Reference text onto ASR word timestamps (counterpart of
``speechflow_tpu/annotator/text_alignment.py``). Host code, numpy only.

Both word sequences are normalised (``normalize_word``: punctuation other than
the apostrophe dropped, lower case) and aligned by a Needleman-Wunsch over the
words' character similarity (``word_similarity``: one minus the normalised
Levenshtein distance), so an ASR substitution ("weather" for "whether") still
anchors. The dynamic programme keeps a band around the length-ratio diagonal
(``nm_align``), linear in the sequence length. ``align_words`` gives each
matched reference word its ASR interval and spreads the unmatched runs between
their anchors by length, the spare time going to terminal punctuation.
"""

from __future__ import annotations

import re
import typing as tp

import numpy as np

__all__ = ["normalize_word", "tokenize_text", "word_similarity", "nm_align", "align_words"]

_PUNCT = re.compile(r"[^\w']+", re.UNICODE)
_TERMINAL = (".", "!", "?", ";")
_NEG = -1e18


def normalize_word(w: str) -> str:
    return _PUNCT.sub("", w).lower()


def tokenize_text(text: str) -> tp.List[str]:
    """The whitespace-separated words that keep a character after normalising."""
    return [w for w in text.strip().split() if normalize_word(w)]


def word_similarity(a: str, b: str) -> float:
    """1 - Levenshtein(a, b) / max(len): 1 for equal words, 0 for an empty one or
    lengths too far apart."""
    if a == b:
        return 1.0
    la, lb = len(a), len(b)
    if la == 0 or lb == 0 or abs(la - lb) >= max(la, lb):
        return 0.0
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        ca, cur = a[i - 1], [i]
        for j in range(1, lb + 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != b[j - 1])))
        prev = cur
    return 1.0 - prev[lb] / max(la, lb)


def nm_align(ref: tp.Sequence[str], asr: tp.Sequence[str], band: tp.Optional[int] = None,
             gap_penalty: float = -0.45, min_similarity: float = 0.5
             ) -> tp.List[tp.Tuple[int, int, float]]:
    """Banded Needleman-Wunsch: the (ref index, asr index, similarity) pairs of the
    best path whose similarity is at least ``min_similarity``. A diagonal step
    scores 2·similarity - 1, a gap ``gap_penalty``; row i keeps the asr columns
    within ``band`` (default max(50, 2·|N - M| + 20)) of round(i·M/N)."""
    n, m = len(ref), len(asr)
    if n == 0 or m == 0:
        return []
    if band is None:
        band = max(50, 2 * abs(n - m) + 20)
    band = min(band, m)

    offsets = np.empty(n + 1, np.int64)
    rows: tp.List[np.ndarray] = []
    moves: tp.List[np.ndarray] = []  # 0 diagonal, 1 up (a ref gap), 2 left (an asr gap)
    sims: tp.Dict[tp.Tuple[int, int], float] = {}
    for i in range(n + 1):
        centre = int(round(i * m / n))
        lo, hi = max(0, centre - band), min(m, centre + band)
        offsets[i] = lo
        row = np.full(hi - lo + 1, _NEG)
        move = np.zeros(hi - lo + 1, np.int8)
        if i == 0:
            row[:] = np.arange(lo, hi + 1) * gap_penalty
            move[:] = 2
        else:
            prev, plo, w = rows[i - 1], offsets[i - 1], ref[i - 1]
            for j in range(lo, hi + 1):
                best, arg = _NEG, 0
                pj = j - plo
                if 0 <= pj < len(prev) and prev[pj] > _NEG / 2:
                    v = prev[pj] + gap_penalty
                    if v > best:
                        best, arg = v, 1
                if j > lo and row[j - lo - 1] > _NEG / 2:
                    v = row[j - lo - 1] + gap_penalty
                    if v > best:
                        best, arg = v, 2
                if j > 0 and 0 <= pj - 1 < len(prev) and prev[pj - 1] > _NEG / 2:
                    s = sims.get((i - 1, j - 1))
                    if s is None:
                        s = sims[(i - 1, j - 1)] = word_similarity(w, asr[j - 1])
                    v = prev[pj - 1] + (2.0 * s - 1.0)
                    if v > best:
                        best, arg = v, 0
                row[j - lo], move[j - lo] = best, arg
        rows.append(row)
        moves.append(move)

    pairs: tp.List[tp.Tuple[int, int, float]] = []
    i, j = n, m
    while i > 0 or j > 0:
        if not 0 <= j - offsets[i] < len(rows[i]):
            break  # off the band (a degenerate input): stop
        mv = moves[i][j - offsets[i]]
        if mv == 0 and i > 0 and j > 0:
            s = sims.get((i - 1, j - 1), 0.0)
            if s >= min_similarity:
                pairs.append((i - 1, j - 1, s))
            i, j = i - 1, j - 1
        elif mv == 1 and i > 0:
            i -= 1
        elif j > 0:
            j -= 1
        else:
            i -= 1
    pairs.reverse()
    return pairs


def align_words(ref_words: tp.Sequence[str], asr_timestamps: tp.Sequence[tp.Sequence],
                total_duration: tp.Optional[float] = None
                ) -> tp.List[tp.Tuple[str, float, float]]:
    """(word, begin, end) for every reference word, from ASR ``[[word, begin,
    end], ...]``. A matched word copies its ASR interval. A run of unmatched
    words between two anchors (or the ends: 0 and ``total_duration``, default
    the last ASR end) gets times in proportion to its words' lengths at the
    anchors' seconds a character; the time left over is silence, put before the
    words after terminal punctuation (evenly between the words if none has
    any); a run longer than its span is squeezed into it. Without any anchor
    the words split the duration evenly. Then begins and ends are made
    monotone."""
    asr_words = [normalize_word(str(t[0])) for t in asr_timestamps]
    ref_norm = [normalize_word(w) for w in ref_words]
    n = len(ref_words)
    begins, ends = np.full(n, np.nan), np.full(n, np.nan)
    for i, j, _ in nm_align(ref_norm, asr_words):
        begins[i], ends[i] = float(asr_timestamps[j][1]), float(asr_timestamps[j][2])
    if total_duration is None:
        total_duration = float(asr_timestamps[-1][2]) if asr_timestamps else 1.0

    anchors = [i for i in range(n) if not np.isnan(begins[i])]
    if not anchors:
        edges = np.linspace(0.0, total_duration, n + 1)
        return [(w, float(edges[i]), float(edges[i + 1])) for i, w in enumerate(ref_words)]
    anchor_secs = sum(ends[k] - begins[k] for k in anchors)
    anchor_chars = sum(len(ref_norm[k]) for k in anchors) or 1
    sec_per_char = max(anchor_secs / anchor_chars, 1e-3)

    i = 0
    while i < n:
        if not np.isnan(begins[i]):
            i += 1
            continue
        j = i
        while j < n and np.isnan(begins[j]):
            j += 1
        left = ends[i - 1] if i > 0 else 0.0
        right = begins[j] if j < n else total_duration
        span, k = max(right - left, 1e-3), j - i
        est = np.array([max(len(ref_norm[i + q]), 1) * sec_per_char for q in range(k)])
        gaps = np.zeros(k + 1)  # silence before word q of the run
        surplus = span - est.sum()
        if surplus > 0:
            slots = [0] if i > 0 and str(ref_words[i - 1]).rstrip().endswith(_TERMINAL) else []
            slots += [q + 1 for q in range(k)
                      if str(ref_words[i + q]).rstrip().endswith(_TERMINAL)]
            if slots:
                for slot in slots:
                    gaps[slot] += surplus / len(slots)
            else:
                gaps[:] = surplus / (k + 1)
        else:
            est = est * (span / est.sum())
        t = left
        for q in range(k):
            t += gaps[q]
            begins[i + q] = t
            t = min(t + est[q], right)
            ends[i + q] = t
        i = j

    for i in range(1, n):
        if begins[i] < ends[i - 1]:
            begins[i] = ends[i - 1]
        if ends[i] < begins[i]:
            ends[i] = begins[i] + 1e-3
    return [(w, float(b), float(e)) for w, b, e in zip(ref_words, begins, ends)]
