"""Linguistic features (counterpart of ``speechflow_tpu/data/processors/ling.py``).

Two producers. Training: ``add_ling_feat`` and ``add_lm_feat`` read a parsed
TextGridStage3 sample (the text parser's word tiers: POS, syntax relations
and heads, emphasis, prosody; the word and phoneme timestamps) and spread
the word-level features over its phonemes, a phoneme's word found by its
midpoint, with rows for the service tokens. Raw text (inference) has no
tiers: ``RuleBasedTagger`` gives the POS (closed-class lexicon + suffix
rules, EN) and punctuation comes from the text itself; the eval interface
builds the features inline and these two handlers leave such a sample as it is.
``word_ling_features`` makes the word-level block of ``ling_feat``, ``_expand``
spreads it over the phonemes; ``lm_feat_for_words`` gives hashed char-n-gram
word embeddings through a fixed random projection; ``add_xpbert_feat`` the
phoneme-level embeddings with the service-row constants.

Features are one dense float32 matrix (N, LING_FEAT_DIM): [sil, word_begin,
word_end, syntagma_end, pos(17), punct(8), emphasis, intonation(3), rel(21),
importance, breath].

With a ``model_ckpt`` (a ``word_lm.pkl`` of ``models/prosody/lm.py``, either
package's), ``lm_feat_for_words`` and ``add_xpbert_feat`` take the trained
WordLM's embeddings instead of the hashed ones.
"""

from __future__ import annotations

import hashlib
import typing as tp

import numpy as np

from speechflow_torch.data.core.datasample import TTSDataSample
from speechflow_torch.data.processors import handler
from speechflow_torch.data.processors.text import SIL

__all__ = [
    "LING_FEAT_DIM", "LM_FEAT_DIM", "XPBERT_FEAT_DIM", "UPOS", "UD_RELS", "PUNCT_CLASSES",
    "RuleBasedTagger", "word_ling_features", "ling_feat_from_text", "lm_feat_for_words",
    "add_ling_feat", "add_lm_feat", "add_xpbert_feat",
]

UPOS = ("ADJ", "ADP", "ADV", "AUX", "CCONJ", "DET", "INTJ", "NOUN", "NUM",
        "PART", "PRON", "PROPN", "PUNCT", "SCONJ", "SYM", "VERB", "X")
UD_RELS = ("root", "nsubj", "obj", "iobj", "obl", "amod", "advmod", "nmod",
           "case", "det", "cop", "mark", "cc", "conj", "aux", "compound",
           "acl", "xcomp", "ccomp", "punct", "other")
PUNCT_CLASSES = ("", ",", ".", "?", "!", ":", ";", "-")
INTONATIONS = (".", "?", "!")

_POS0 = 4
_PUNCT0 = _POS0 + len(UPOS)
_EMPH = _PUNCT0 + len(PUNCT_CLASSES)
_INT0 = _EMPH + 1
_REL0 = _INT0 + len(INTONATIONS)
_IMPORTANCE = _REL0 + len(UD_RELS)
_BREATH = _IMPORTANCE + 1

LING_FEAT_DIM = _BREATH + 1
LM_FEAT_DIM = 32
XPBERT_FEAT_DIM = 32


class RuleBasedTagger:
    """Closed-class lexicon + suffix heuristics for English UPOS tagging:
    function words are exact; open-class words fall back to suffix rules
    with NOUN as the default."""

    LEXICON: tp.Dict[str, str] = {}
    for w in ("the", "a", "an", "this", "that", "these", "those", "each",
              "every", "either", "neither", "some", "any", "no", "all", "both"):
        LEXICON[w] = "DET"
    for w in ("in", "on", "at", "by", "for", "with", "from", "to", "of",
              "into", "onto", "over", "under", "about", "against", "between",
              "through", "during", "before", "after", "above", "below", "up",
              "down", "out", "off", "near", "without", "within", "upon"):
        LEXICON[w] = "ADP"
    for w in ("i", "you", "he", "she", "it", "we", "they", "me", "him", "her",
              "us", "them", "my", "your", "his", "its", "our", "their", "mine",
              "yours", "hers", "ours", "theirs", "myself", "yourself", "who",
              "whom", "whose", "which", "what", "something", "anything",
              "nothing", "everything", "someone", "anyone", "everyone"):
        LEXICON[w] = "PRON"
    for w in ("and", "or", "but", "nor", "yet", "so"):
        LEXICON[w] = "CCONJ"
    for w in ("if", "because", "although", "though", "while", "whereas",
              "unless", "until", "since", "when", "whenever", "where", "as",
              "that", "whether"):
        LEXICON.setdefault(w, "SCONJ")
    for w in ("be", "am", "is", "are", "was", "were", "been", "being", "have",
              "has", "had", "having", "do", "does", "did", "will", "would",
              "shall", "should", "may", "might", "must", "can", "could"):
        LEXICON[w] = "AUX"
    for w in ("not", "n't", "'s", "to"):
        LEXICON.setdefault(w, "PART")
    for w in ("very", "too", "quite", "rather", "almost", "also", "just",
              "only", "even", "still", "already", "always", "never", "often",
              "sometimes", "now", "then", "here", "there", "again", "soon",
              "perhaps", "maybe", "however", "moreover", "instead", "indeed",
              "most", "more", "less", "least", "well"):
        LEXICON.setdefault(w, "ADV")
    for w in ("oh", "ah", "wow", "hey", "ouch", "hello", "hi", "yes", "yeah"):
        LEXICON[w] = "INTJ"

    SUFFIX_RULES = (
        ("ly", "ADV"), ("ing", "VERB"), ("ed", "VERB"), ("tion", "NOUN"),
        ("sion", "NOUN"), ("ness", "NOUN"), ("ment", "NOUN"), ("ity", "NOUN"),
        ("ism", "NOUN"), ("ous", "ADJ"), ("ful", "ADJ"), ("ive", "ADJ"),
        ("ical", "ADJ"), ("able", "ADJ"), ("ible", "ADJ"), ("less", "ADJ"),
        ("est", "ADJ"), ("ize", "VERB"), ("ise", "VERB"), ("ify", "VERB"),
    )

    def __call__(self, word: str) -> str:
        w = word.strip().lower().strip("".join(PUNCT_CLASSES[1:]) + "\"'()")
        if not w:
            return "PUNCT"
        if any(c.isdigit() for c in w):
            return "NUM"
        if w in self.LEXICON:
            return self.LEXICON[w]
        for suf, tag in self.SUFFIX_RULES:
            if len(w) > len(suf) + 2 and w.endswith(suf):
                return tag
        if word[:1].isupper():
            return "PROPN"
        return "NOUN"


def _one_hot_index(vocab: tp.Sequence[str], value: tp.Optional[str]) -> int:
    if value is None:
        return len(vocab) - 1
    v = value.strip()
    if v in vocab:
        return vocab.index(v)
    # UD subtypes like "acl:relcl" map to their base relation
    base = v.split(":")[0]
    return vocab.index(base) if base in vocab else len(vocab) - 1


def _trailing_punct(word: str) -> str:
    for ch in reversed(word.strip().strip("\"'")):
        if ch.isalnum():
            return ""
        if ch in PUNCT_CLASSES:
            return ch
        if ch in "—–":
            return "-"
    return ""


def _head_counts(word_ids: tp.Optional[tp.Sequence[str]],
                 head_ids: tp.Optional[tp.Sequence[str]], n: int) -> np.ndarray:
    counts = np.zeros(n, np.float32)
    if not word_ids or not head_ids:
        return counts
    tally: tp.Dict[str, int] = {}
    for h in head_ids:
        if h:
            tally[h] = tally.get(h, 0) + 1
    for i, wid in enumerate(word_ids):
        counts[i] = tally.get(wid, 0)
    return counts


def word_ling_features(
    words: tp.Sequence[str],
    pos_tags: tp.Optional[tp.Sequence[str]] = None,
    syntax_rels: tp.Optional[tp.Sequence[str]] = None,
    word_ids: tp.Optional[tp.Sequence[str]] = None,
    head_ids: tp.Optional[tp.Sequence[str]] = None,
    emphasis_labels: tp.Optional[tp.Sequence[str]] = None,
    intonation: str = ".",
    tagger: tp.Optional[RuleBasedTagger] = None,
) -> np.ndarray:
    """(n_words, LING_FEAT_DIM) word-level block; positional flags stay zero
    here and are set during phoneme expansion."""
    n = len(words)
    feats = np.zeros((n, LING_FEAT_DIM), np.float32)
    if pos_tags is None:
        tagger = tagger or RuleBasedTagger()
        pos_tags = [tagger(w) for w in words]
    importance = _head_counts(word_ids, head_ids, n)
    for i, w in enumerate(words):
        feats[i, _POS0 + _one_hot_index(UPOS, pos_tags[i] if i < len(pos_tags) else None)] = 1.0
        punct = _trailing_punct(w)
        feats[i, _PUNCT0 + (PUNCT_CLASSES.index(punct) if punct in PUNCT_CLASSES else 0)] = 1.0
        if emphasis_labels is not None and i < len(emphasis_labels):
            feats[i, _EMPH] = 1.0 if emphasis_labels[i] == "accent" else 0.0
        if syntax_rels is not None and i < len(syntax_rels):
            feats[i, _REL0 + _one_hot_index(UD_RELS, syntax_rels[i])] = 1.0
        feats[i, _IMPORTANCE] = min(importance[i], 8.0) / 8.0
    intonation = intonation if intonation in INTONATIONS else "."
    feats[:, _INT0 + INTONATIONS.index(intonation)] = 1.0
    return feats


def _expand(word_feats: np.ndarray, word_map: np.ndarray,
            phonemes: tp.Sequence[str],
            syntagma_last_words: tp.Optional[tp.Set[int]] = None) -> np.ndarray:
    """Word rows spread over the phonemes (``word_map``: word index per
    phoneme, -1 for pauses), with word begin/end flags and pause rows."""
    n = len(phonemes)
    out = np.zeros((n, LING_FEAT_DIM), np.float32)
    for i, w in enumerate(word_map):
        if phonemes[i] in (SIL, "", None):
            out[i, 0] = 1.0
            out[i, _BREATH] = -3.0 / 10.0
            continue
        if w >= 0 and w < len(word_feats):
            out[i] = word_feats[w]
            if i == 0 or word_map[i - 1] != w:
                out[i, 1] = 1.0  # word_begin
            if i == n - 1 or word_map[i + 1] != w:
                out[i, 2] = 1.0  # word_end
                if syntagma_last_words and int(w) in syntagma_last_words:
                    out[i, 3] = 1.0
        else:
            out[i, 0] = 1.0  # sil_mask
            out[i, _BREATH] = -3.0 / 10.0  # breath prior at pauses
    return out


def _phoneme_word_map(ds: TTSDataSample) -> np.ndarray:
    """Word index per phoneme (-1 for pauses): the first word whose interval
    holds the phoneme's midpoint."""
    out = np.full(len(ds.phonemes), -1, np.int64)
    if ds.word_timestamps is None or ds.phoneme_timestamps is None:
        return out
    wts = np.asarray(ds.word_timestamps.intervals, np.float64)
    for i, ((b, e), lab) in enumerate(zip(ds.phoneme_timestamps, ds.phonemes)):
        if lab in (SIL, "", None):
            continue
        mid = 0.5 * (b + e)
        hits = np.nonzero((wts[:, 0] - 1e-6 <= mid) & (mid <= wts[:, 1] + 1e-6))[0]
        if len(hits):
            out[i] = int(hits[0])
    return out


def _with_service_rows(mat: np.ndarray, ds: TTSDataSample, sil: bool) -> np.ndarray:
    """BOS/EOS rows (sil-marked when ``sil``) where the transcription has
    service tokens."""
    if ds.n_tokens and ds.n_tokens == mat.shape[0] + 2:
        row = np.zeros((1, mat.shape[1]), mat.dtype)
        if sil:
            row[0, 0] = 1.0
        mat = np.concatenate([row, mat, row], axis=0)
    return mat


def _syntagma_last_words(ds: TTSDataSample) -> tp.Optional[tp.Set[int]]:
    ids = ds.syntagma_ids
    if not ids:
        return None
    return {i for i in range(len(ids)) if i + 1 == len(ids) or ids[i + 1] != ids[i]}


@handler(inputs={"phonemes", "transcription"}, outputs={"ling_feat", "prosody", "word_lengths"},
         optional={"pos_tags", "syntax_rels", "emphasis_labels", "prosody_labels"})
def add_ling_feat(ds: TTSDataSample, use_rule_tagger_fallback: bool = True) -> TTSDataSample:
    """Per-phoneme linguistic features, prosody class ids (the word's
    prosody label + 1, -1 undefined) and word lengths (runs of one word;
    pauses and service tokens are runs of one) of a parsed sample."""
    if ds.phoneme_timestamps is None or ds.word_timestamps is None:
        return ds  # raw text: the eval interface computes the features inline
    words = ds.text.split() if ds.text else []
    if ds.pos_tags is None and not use_rule_tagger_fallback:
        return ds
    text = (ds.text or "").rstrip()
    word_feats = word_ling_features(
        words, pos_tags=ds.pos_tags, syntax_rels=ds.syntax_rels, word_ids=ds.word_ids,
        head_ids=ds.head_ids, emphasis_labels=ds.emphasis_labels,
        intonation="?" if text.endswith("?") else ("!" if text.endswith("!") else "."))
    word_map = _phoneme_word_map(ds)
    ds.ling_feat = _with_service_rows(
        _expand(word_feats, word_map, ds.phonemes, _syntagma_last_words(ds)), ds, sil=True)

    pros = np.full(len(ds.phonemes), -1, np.int32)
    if ds.prosody_labels:
        for i, w in enumerate(word_map):
            if 0 <= w < len(ds.prosody_labels):
                lab = str(ds.prosody_labels[w]).strip()
                if lab and lab not in ("undefined", "-1"):
                    try:
                        pros[i] = int(float(lab)) + 1
                    except ValueError:
                        pass
    if ds.n_tokens == len(pros) + 2:
        pros = np.concatenate([[-1], pros, [-1]]).astype(np.int32)
    ds.prosody = pros

    wm = list(word_map)
    if ds.n_tokens == len(wm) + 2:
        wm = [-2] + wm + [-3]
    groups, run = [], 0
    for i in range(len(wm)):
        run += 1
        nxt = wm[i + 1] if i + 1 < len(wm) else None
        if nxt is None or nxt != wm[i] or wm[i] < 0:
            groups.append(run)
            run = 0
    ds.word_lengths = np.asarray(groups, np.int32)
    return ds


@handler(inputs={"phonemes", "transcription"}, outputs={"lm_feat"})
def add_lm_feat(ds: TTSDataSample, model_ckpt: tp.Optional[str] = None) -> TTSDataSample:
    """Each phoneme gets its word's embedding (pauses and service tokens 0)."""
    if ds.phoneme_timestamps is None or ds.word_timestamps is None:
        return ds  # raw text: the eval interface computes the features inline
    wf = lm_feat_for_words(ds.text.split() if ds.text else [], model_ckpt=model_ckpt)
    mat = np.zeros((len(ds.phonemes), LM_FEAT_DIM), np.float32)
    for i, w in enumerate(_phoneme_word_map(ds)):
        if 0 <= w < len(wf):
            mat[i] = wf[w]
    ds.lm_feat = _with_service_rows(mat, ds, sil=False)
    return ds


def ling_feat_from_text(words: tp.Sequence[str],
                        phonemes_per_word: tp.Sequence[int],
                        add_service_tokens: bool = True,
                        intonation: str = ".") -> np.ndarray:
    """(N, LING_FEAT_DIM) for raw-text synthesis: rule-tagged POS + text
    punctuation, expanded by the per-word phoneme counts (pauses are passed
    as 'words' with an empty label or SIL)."""
    word_feats = word_ling_features(list(words), intonation=intonation)
    rows = []
    for i, (w, cnt) in enumerate(zip(words, phonemes_per_word)):
        for j in range(cnt):
            row = word_feats[i].copy()
            if not w or w == SIL:
                row[:] = 0.0
                row[0] = 1.0
                row[_BREATH] = -0.3
            else:
                row[1] = 1.0 if j == 0 else 0.0
                row[2] = 1.0 if j == cnt - 1 else 0.0
            rows.append(row)
    mat = np.stack(rows) if rows else np.zeros((0, LING_FEAT_DIM), np.float32)
    if add_service_tokens:
        row = np.zeros((1, LING_FEAT_DIM), np.float32)
        row[0, 0] = 1.0
        mat = np.concatenate([row, mat, row.copy()], axis=0)
    return mat.astype(np.float32)


# the JAX package draws this projection at import from the same seed
_LM_PROJ = np.random.default_rng(0x5F3C).normal(
    0, 1.0 / np.sqrt(64), size=(4096, LM_FEAT_DIM)).astype(np.float32)


def _char_ngrams(word: str, n_lo: int = 2, n_hi: int = 4) -> tp.List[str]:
    w = f"<{word.strip().lower()}>"
    out = []
    for n in range(n_lo, n_hi + 1):
        out += [w[i:i + n] for i in range(max(len(w) - n + 1, 1))]
    return out


_WORD_LMS: tp.Dict[str, tp.Any] = {}


def _get_word_lm(ckpt: tp.Optional[str]):
    """The WordLM pickle at ``ckpt`` (loaded once per path), None without one."""
    if not ckpt:
        return None
    if ckpt not in _WORD_LMS:
        from speechflow_torch.models.prosody.lm import WordLM

        _WORD_LMS[ckpt] = WordLM.load(ckpt)
    return _WORD_LMS[ckpt]


def lm_feat_for_words(words: tp.Sequence[str],
                      model_ckpt: tp.Optional[str] = None) -> np.ndarray:
    """(n_words, LM_FEAT_DIM) word embeddings: with ``model_ckpt`` a trained
    WordLM's (``WordLM.embed``, cut or zero-padded to LM_FEAT_DIM), else hashed
    char n-grams (blake2s) through a fixed random projection, each word's sum
    over sqrt(#grams)."""
    lm = _get_word_lm(model_ckpt)
    if lm is not None:
        emb = lm.embed(list(words))
        if emb.shape[1] >= LM_FEAT_DIM:
            return emb[:, :LM_FEAT_DIM].astype(np.float32)
        out = np.zeros((len(words), LM_FEAT_DIM), np.float32)
        out[:, :emb.shape[1]] = emb
        return out
    out = np.zeros((len(words), LM_FEAT_DIM), np.float32)
    for i, w in enumerate(words):
        grams = _char_ngrams(w)
        for g in grams:
            h = int.from_bytes(hashlib.blake2s(g.encode(), digest_size=4).digest(), "little")
            out[i] += _LM_PROJ[h % len(_LM_PROJ)]
        if grams:
            out[i] /= np.sqrt(len(grams))
    return out


@handler(inputs={"phonemes", "transcription"}, outputs={"xpbert_feat"})
def add_xpbert_feat(ds: TTSDataSample, model_ckpt: tp.Optional[str] = None) -> TTSDataSample:
    """Per-phoneme embeddings (a phoneme-level WordLM's at ``model_ckpt``, cut
    or zero-padded to XPBERT_FEAT_DIM, else the char-n-gram embeddings of the
    phoneme symbols); rows of SIL are 0.1, and BOS/EOS rows 0.01 / -0.01 when
    the transcription has service tokens."""
    if ds.phonemes is None:
        return ds
    phonemes = list(ds.phonemes)
    lm = _get_word_lm(model_ckpt)
    if lm is not None:
        mat = lm.embed(phonemes)[:, :XPBERT_FEAT_DIM].astype(np.float32)
        if mat.shape[1] < XPBERT_FEAT_DIM:
            mat = np.pad(mat, ((0, 0), (0, XPBERT_FEAT_DIM - mat.shape[1])))
    else:
        mat = lm_feat_for_words(phonemes)[:, :XPBERT_FEAT_DIM].astype(np.float32)
    for i, p in enumerate(phonemes):
        if p == SIL:
            mat[i] = 0.1
    n_tokens = ds.n_tokens
    if n_tokens and n_tokens == mat.shape[0] + 2:  # BOS/EOS service rows
        bos = np.full((1, XPBERT_FEAT_DIM), 0.01, np.float32)
        eos = np.full((1, XPBERT_FEAT_DIM), -0.01, np.float32)
        mat = np.concatenate([bos, mat, eos], axis=0)
    ds.xpbert_feat = mat
    return ds
