"""Grapheme-to-phoneme model (counterpart of
``speechflow_tpu/models/g2p/model.py``): the lexicon miner, the EM
grapheme->phoneme aligner, the chunk tagger's training and ``G2P`` itself
(``load``, ``save``, ``predict``).

A ``g2p.pkl`` holds the char and language vocabularies, the phoneme-chunk
inventory, the mined lexicon, optional chunk-class bigrams, and the tagger's
parameters: one tree, or a list of them (a seed ensemble whose log-softmax
outputs are averaged). ``predict`` is lexicon-first; the other words go
through the tagger (``arch="gru"``: a bidirectional GRU over the whole word;
``"mlp"``: a window MLP over ``win`` characters), one batched forward on the
G2P's device, then per word a Viterbi pass over the bigrams (when
``bigram_weight > 0``) or the argmax, and the chunks are concatenated.

The pickle's parameters are numpy arrays, in either package's ``save``, so
each package loads the other's. ``train_g2p`` trains as JAX's does: every
member full-batch for ``steps`` AdamW steps (``weight_decay`` decoupled, as
``optax.adamw``), label-smoothed as ``(1 - ls)·nll - ls·mean(log p)``, from
``init_tagger_params`` drawn by numpy's generator seeded ``seed + 1000·m``
(bit for bit JAX's). The members train together, stacked (one batched op
runs them all; AdamW is elementwise, so each still steps alone). Dropout
draws its masks from torch's generator seeded ``seed`` (JAX draws from
``fold_in(PRNGKey(seed + 1000·m), step)``), so a run with dropout is JAX's in
law, not in values. On the GPU the training step is captured once as a CUDA
graph and replayed: the tagger is small, and an eager step would be hundreds
of kernel launches.
"""

from __future__ import annotations

import contextlib
import pickle
import re
import typing as tp
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.utils.device import resolve_device

__all__ = ["G2P", "train_g2p", "mine_g2p_lexicon", "align_lexicon", "init_tagger_params",
           "normalize_word", "phoneme_error_rate"]

_WORD_CLEAN_RE = re.compile(r"[^\w']+", re.UNICODE)
MAX_WORD = 24     # longest word the miner accepts
MAX_PHON = 28     # longest pronunciation the miner accepts
BOW, EOW, UNK_CHAR = "<", ">", "\0"   # window boundary / unknown-char markers

Lexicon = tp.List[tp.Tuple[str, str, tp.Tuple[str, ...]]]


def normalize_word(word: str) -> str:
    return _WORD_CLEAN_RE.sub("", word.lower())


def phoneme_error_rate(pred: tp.Sequence[str], ref: tp.Sequence[str]) -> float:
    """Levenshtein distance / reference length."""
    m, n = len(pred), len(ref)
    d = np.zeros((m + 1, n + 1), np.int32)
    d[:, 0] = np.arange(m + 1)
    d[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                          d[i - 1, j - 1] + (pred[i - 1] != ref[j - 1]))
    return float(d[m, n]) / max(n, 1)


def mine_g2p_lexicon(seg_paths: tp.Iterable[tp.Union[str, Path]]) -> Lexicon:
    """The sorted (lang, word, phonemes) entries of TextGrid segs: each
    word's phoneme intervals are those inside its interval. Files that do
    not parse, words longer than ``MAX_WORD``, pronunciations longer than
    ``MAX_PHON`` and words holding a service token (BOS, EOS, SIL, UNK) are
    skipped."""
    from speechflow_torch.io.seg import AudioSeg

    lex: tp.Set[tp.Tuple[str, str, tp.Tuple[str, ...]]] = set()
    for p in seg_paths:
        p = Path(p)
        try:
            seg = AudioSeg.load(p)
        except Exception:  # as JAX's miner: an unreadable seg is skipped
            continue
        lang = seg.lang or ("RU" if "RU" in str(p) else "EN")
        phones = list(seg.phonemes())
        for ws, we, wtext in seg.words():
            w = normalize_word(wtext)
            if not w or len(w) > MAX_WORD:
                continue
            pron = tuple(lbl for (s, e, lbl) in phones
                         if s >= ws - 1e-6 and e <= we + 1e-6 and lbl)
            if any(x in ("BOS", "EOS", "SIL", "UNK") for x in pron):
                continue
            if pron and len(pron) <= MAX_PHON:
                lex.add((lang, w, pron))
    return sorted(lex)


def align_lexicon(lexicon: Lexicon, iters: int = 3, max_emit: int = 2,
                  eps_penalty: float = 2.0, multi_penalty: float = 1.0
                  ) -> tp.List[tp.Optional[tp.List[tp.Tuple[str, ...]]]]:
    """Each entry's phoneme chunks, one per grapheme (0..``max_emit`` phonemes
    each), or None when the budget cannot cover the pronunciation: a Viterbi
    pass over log co-occurrence scores (uniform within a word at first, then
    the previous round's alignment counts) for ``iters`` rounds."""
    neg = -1e9
    score: tp.Dict[str, tp.Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for _, w, pron in lexicon:
        for g in w:
            for p in pron:
                score[g][p] += 1.0 / (len(w) * len(pron))

    aligns: tp.List[tp.Optional[tp.List[tp.Tuple[str, ...]]]] = []
    for _ in range(iters):
        counts: tp.Dict[str, tp.Dict[str, float]] = defaultdict(lambda: defaultdict(float))
        aligns = []
        for _, w, pron in lexicon:
            n_g, n_p = len(w), len(pron)
            d = np.full((n_g + 1, n_p + 1), neg)
            d[0, 0] = 0.0
            back: tp.Dict[tp.Tuple[int, int], int] = {}

            def s(g: str, p: str) -> float:
                return float(np.log(score[g][p] + 1e-4))

            for i in range(1, n_g + 1):
                g = w[i - 1]
                for j in range(n_p + 1):
                    best, arg = neg, 0
                    if d[i - 1, j] > neg / 2:                      # emit nothing
                        v = d[i - 1, j] - eps_penalty
                        if v > best:
                            best, arg = v, 0
                    for k in range(1, min(max_emit, j) + 1):       # emit k phonemes
                        if d[i - 1, j - k] > neg / 2:
                            v = (d[i - 1, j - k] - multi_penalty * (k - 1)
                                 + sum(s(g, pron[j - m - 1]) for m in range(k)))
                            if v > best:
                                best, arg = v, k
                    d[i, j], back[(i, j)] = best, arg
            if d[n_g, n_p] <= neg / 2:
                aligns.append(None)
                continue
            i, j, chunks = n_g, n_p, []
            while i > 0:
                k = back[(i, j)]
                chunks.append(tuple(pron[j - k: j]))
                i, j = i - 1, j - k
            chunks.reverse()
            aligns.append(chunks)
            for g, ch in zip(w, chunks):
                for p in ch:
                    counts[g][p] += 1.0
        score = counts
    return aligns


def init_tagger_params(rng: np.random.Generator, arch: str, n_chars: int, n_langs: int,
                       n_chunks: int, char_dim: int = 24, hidden: int = 384, win: int = 7,
                       gru_hidden: int = 64) -> tp.Dict[str, np.ndarray]:
    """A fresh tagger, drawn as ``speechflow_tpu``'s ``train_g2p`` draws one
    (its ``init_params``): each matrix N(0, 1/fan_in) from ``rng`` in the JAX
    trainer's order, the char and language tables scaled by 0.1, biases 0;
    float32. The same generator state gives the same arrays."""
    def mat(fan_in, *shape):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    d = char_dim
    if arch == "gru":
        h = gru_hidden
        p = {"ce": 0.1 * mat(1, n_chars, d), "le": 0.1 * mat(1, n_langs, d),
             "w1": mat(2 * h, 2 * h, 2 * h), "b1": np.zeros(2 * h, np.float32),
             "wo": mat(2 * h, 2 * h, n_chunks), "bo": np.zeros(n_chunks, np.float32)}
        for side in ("f_", "b_"):
            for g in ("z", "r", "n"):
                p[side + "W" + g] = mat(d, d, h)
                p[side + "U" + g] = mat(h, h, h)
                p[side + "b" + g] = np.zeros(h, np.float32)
        return p
    if arch != "mlp":
        raise ValueError(f"unknown G2P arch {arch!r} (gru or mlp)")
    return {"ce": 0.1 * mat(1, n_chars, d), "le": 0.1 * mat(1, n_langs, d),
            "w1": mat(win * d, win * d + d, hidden), "b1": np.zeros(hidden, np.float32),
            "w2": mat(hidden, hidden, hidden), "b2": np.zeros(hidden, np.float32),
            "wo": mat(hidden, hidden, n_chunks), "bo": np.zeros(n_chunks, np.float32)}


def _affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each member's x·W + b: x (M, ..., I), w (M, I, O), b (M, O) -> (M, ..., O)
    (one ``baddbmm`` over the flattened rows: a broadcast matmul would copy W
    for every row)."""
    m, rows = x.shape[0], x.shape[1:-1]
    out = torch.baddbmm(b[:, None], x.reshape(m, -1, x.shape[-1]), w)
    return out.reshape(m, *rows, w.shape[-1])


class _Ensemble(nn.Module):
    """The ensemble's taggers, each parameter stacked over the members on a
    leading axis (float32), so that one batched op runs every member (and, in
    the GRU, both directions). ``jax.nn.gelu``, which the trainer uses, is the
    tanh form. In training mode ``dropout`` masks what JAX's trainer masks: the
    GRU's embeddings and its outputs, the MLP's input and its first hidden
    layer (each element kept with probability 1 - dropout and scaled by its
    inverse)."""

    def __init__(self, members: tp.Sequence[tp.Mapping[str, np.ndarray]], arch: str, win: int,
                 dropout: float = 0.0):
        super().__init__()
        self.arch, self.win, self.dropout = arch, win, dropout
        self.p = nn.ParameterDict({
            k: nn.Parameter(torch.from_numpy(np.stack([np.asarray(m[k], np.float32)
                                                       for m in members])))
            for k in members[0]})

    def __len__(self) -> int:
        return self.p["ce"].shape[0]

    def member_params(self) -> tp.List[tp.Dict[str, np.ndarray]]:
        """Each member's parameter tree as float32 numpy (the pickle's layout)."""
        arrays = {k: v.detach().cpu().numpy() for k, v in self.p.items()}
        return [{k: np.ascontiguousarray(v[m]) for k, v in arrays.items()}
                for m in range(len(self))]

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.dropout <= 0:
            return x
        keep = 1.0 - self.dropout
        return x * (torch.rand_like(x) < keep).to(x.dtype) / keep

    def _gru(self, e: torch.Tensor) -> torch.Tensor:
        """(M, B, L, D) -> (M, B, L, 2H): each member's forward GRU and its
        backward one (JAX's ``scan(reverse=True)``: the flipped sequence, the
        output flipped back), the 2M recurrences in one batched loop.
        z, r = σ(x·W + h·U + b), n = tanh(x·Wn + (r ⊙ h)·Un + bn),
        h = (1 - z)·n + z·h; the input products of every step in one matmul."""
        p, m = self.p, e.shape[0]

        def both(name: str) -> torch.Tensor:
            return torch.cat([p["f_" + name], p["b_" + name]])

        hid = p["f_Uz"].shape[-1]
        x = torch.cat([e, e.flip(2)])
        xzr = _affine(x, torch.cat([both("Wz"), both("Wr")], -1),
                      torch.cat([both("bz"), both("br")], -1))
        xn = _affine(x, both("Wn"), both("bn"))
        u_zr, u_n = torch.cat([both("Uz"), both("Ur")], -1), both("Un")
        h = e.new_zeros(2 * m, e.shape[1], hid)
        out = []
        # unbound once: a slice a step would give its backward a zero-filled copy a step
        for x_zr, x_n in zip(xzr.unbind(2), xn.unbind(2)):
            z, r = torch.sigmoid(x_zr + torch.bmm(h, u_zr)).split(hid, -1)
            n = torch.tanh(x_n + torch.bmm(r * h, u_n))
            h = (1 - z) * n + z * h
            out.append(h)
        hs = torch.stack(out, dim=2)
        return torch.cat([hs[:m], hs[m:].flip(2)], -1)

    def forward(self, x: torch.Tensor, lang_ids: tp.Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``gru``: x (B, L) char ids, lang_ids (B,) -> (M, B, L, n_chunks);
        ``mlp``: x (N, win+1) window ids + a lang id -> (M, N, n_chunks)."""
        p = self.p

        def dense(h, w, b):
            return _affine(h, p[w], p[b])

        if self.arch == "gru":
            e = self._drop(p["ce"][:, x] + p["le"][:, lang_ids][:, :, None])
            h = self._drop(self._gru(e))
            h = F.gelu(dense(h, "w1", "b1"), approximate="tanh")
        else:
            n_rows = x.shape[0]
            h = self._drop(torch.cat([p["ce"][:, x[:, :self.win]].reshape(len(self), n_rows, -1),
                                      p["le"][:, x[:, self.win]]], -1))
            h = self._drop(F.gelu(dense(h, "w1", "b1"), approximate="tanh"))
            h = F.gelu(dense(h, "w2", "b2"), approximate="tanh")
        return dense(h, "wo", "bo")


class G2P:
    def __init__(self, cvocab: tp.Dict[str, int], lvocab: tp.Dict[str, int],
                 chunk_symbols: tp.Sequence[tp.Tuple[str, ...]],
                 params: tp.Union[dict, tp.Sequence[dict]], win: int = 7,
                 lexicon: tp.Optional[tp.Dict[tp.Tuple[str, str], tp.Tuple[str, ...]]] = None,
                 bigrams: tp.Optional[tp.Tuple[np.ndarray, np.ndarray]] = None,
                 bigram_weight: float = 0.0, arch: str = "mlp",
                 device: tp.Union[str, torch.device, None] = None):
        """``device``: where the tagger runs (the GPU unless ``device="cpu"``)."""
        self.cvocab = dict(cvocab)
        self.lvocab = dict(lvocab)
        self.chunk_symbols = [tuple(c) for c in chunk_symbols]
        self.win = win
        self.arch = arch
        self.bigrams = bigrams
        self.bigram_weight = float(bigram_weight)
        self.lexicon = dict(lexicon or {})
        self._cache: tp.Dict[tp.Tuple[str, str], tp.Tuple[str, ...]] = {}
        self.params = params
        members = list(params) if isinstance(params, (list, tuple)) else [params]
        self.device = resolve_device(device)
        self.members = _Ensemble(members, arch, win).to(self.device)
        self.members.eval().requires_grad_(False)

    @property
    def phoneme_inventory(self) -> tp.List[str]:
        return sorted({p for ch in self.chunk_symbols for p in ch})

    def _features(self, word: str, lang: str) -> np.ndarray:
        """(len(word), win+1) int32 rows of window char ids + lang id."""
        half = self.win // 2
        unk = self.cvocab[UNK_CHAR]
        padded = BOW * half + word + EOW * half
        lid = self.lvocab.get(lang.upper(), 0)
        rows = [[self.cvocab.get(padded[i + k], unk) for k in range(self.win)] + [lid]
                for i in range(len(word))]
        return np.asarray(rows, np.int32)

    @torch.inference_mode()
    def _log_probs(self, words: tp.Sequence[str], lang: str) -> tp.List[np.ndarray]:
        """Each word's (len(word), n_chunks) log-probs, averaged over the
        ensemble's log-softmax."""
        dev = self.device
        if self.arch == "gru":
            unk, pad_id = self.cvocab[UNK_CHAR], self.cvocab[EOW]
            # the padded length is part of the result (the backward GRU starts
            # at the pad): the JAX package's bucket, a power of two >= 8
            length = 1 << max(3, int(max(len(w) for w in words) - 1).bit_length())
            x = np.full((len(words), length), pad_id, np.int32)
            for i, w in enumerate(words):
                x[i, :len(w)] = [self.cvocab.get(c, unk) for c in w]
            lid = torch.full((len(words),), self.lvocab.get(lang.upper(), 0), device=dev)
            args = (torch.from_numpy(x).to(dev, torch.long), lid)
        else:
            feats = [self._features(w, lang) for w in words]
            args = (torch.from_numpy(np.concatenate(feats)).to(dev, torch.long),)
        lp = F.log_softmax(self.members(*args), -1).mean(0).float().cpu().numpy()
        if self.arch == "gru":
            return [lp[i, :len(w)] for i, w in enumerate(words)]
        bounds = np.cumsum([0] + [len(w) for w in words])
        return [lp[a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    def _decode(self, logp: np.ndarray) -> tp.List[int]:
        """Per-word class decode from (T, C) log-probs: Viterbi over the
        mined chunk-class bigram when available, argmax otherwise."""
        if self.bigrams is None or self.bigram_weight <= 0 or len(logp) == 0:
            return [int(c) for c in logp.argmax(-1)]
        log_s, log_t = self.bigrams
        w = self.bigram_weight
        score = logp[0] + w * log_s
        back = []
        for t in range(1, len(logp)):
            m = score[:, None] + w * log_t            # (prev, next)
            back.append(m.argmax(0))
            score = m.max(0) + logp[t]
        path = [int(score.argmax())]
        for bk in reversed(back):
            path.append(int(bk[path[-1]]))
        path.reverse()
        return path

    def predict(self, words: tp.Sequence[str], lang: str = "EN",
                use_lexicon: bool = True) -> tp.List[tp.Tuple[str, ...]]:
        """Lexicon lookup for known words, one batched forward over the
        others; memoized per (word, lang)."""
        lang = lang.upper()
        lex = self.lexicon if use_lexicon else {}

        def known(w: str) -> bool:
            key = (lang, normalize_word(w))
            return key in lex or key in self._cache

        todo = sorted({normalize_word(w) for w in words if normalize_word(w) and not known(w)})
        if todo:
            for w, logp in zip(todo, self._log_probs(todo, lang)):
                pron: tp.List[str] = []
                for c in self._decode(logp):
                    pron.extend(self.chunk_symbols[c])
                self._cache[(lang, w)] = tuple(pron)
        out = []
        for w in words:
            key = (lang, normalize_word(w))
            out.append(lex.get(key) or self._cache.get(key, ()))
        return out

    def save(self, path: tp.Union[str, Path]) -> Path:
        """JAX's ``G2P.save`` layout: one pickle of the vocabularies, chunks,
        parameters (numpy), lexicon and bigrams."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"cvocab": self.cvocab, "lvocab": self.lvocab,
                         "chunk_symbols": self.chunk_symbols, "params": self.params,
                         "win": self.win, "lexicon": self.lexicon, "bigrams": self.bigrams,
                         "bigram_weight": self.bigram_weight, "arch": self.arch}, f)
        return path

    @classmethod
    def load(cls, path: tp.Union[str, Path],
             device: tp.Union[str, torch.device, None] = None) -> "G2P":
        """A ``g2p.pkl`` written by either package's ``G2P.save``. Unpickling
        runs code: read only files this project's trainer wrote."""
        with open(path, "rb") as f:
            tree = pickle.load(f)
        return cls(tree["cvocab"], tree["lvocab"], tree["chunk_symbols"], tree["params"],
                   tree.get("win", 7), tree.get("lexicon"), bigrams=tree.get("bigrams"),
                   bigram_weight=tree.get("bigram_weight", 0.0),
                   arch=tree.get("arch", "mlp"), device=device)


def _fit(model: _Ensemble, loss_of: tp.Callable[[_Ensemble], torch.Tensor], steps: int,
         lr: float, weight_decay: float, seed: int) -> None:
    """``steps`` full-batch AdamW steps of every member of ``model`` in place
    (``loss_of`` sums the members' losses; AdamW is elementwise, so each member
    steps alone), dropout drawn from torch's generator seeded ``seed`` (the
    caller's generator state is restored after). On the GPU, three eager steps
    warm up and the fourth is captured as a CUDA graph that the rest replay."""
    from speechflow_torch.training.optimizer import optax_optimizer

    dev = next(model.parameters()).device
    graph = dev.type == "cuda"
    opt = optax_optimizer(model.parameters(), "adamw", lr, weight_decay, capturable=graph)

    def step() -> None:
        loss_of(model).backward()
        opt.step()

    with torch.random.fork_rng(devices=[dev] if graph else []):
        torch.manual_seed(seed)
        warm = min(steps, 3) if graph else steps
        stream = torch.cuda.Stream(dev) if graph else None
        if graph:
            stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream) if graph else contextlib.nullcontext():
            for _ in range(warm):
                opt.zero_grad(set_to_none=True)
                step()
        if graph:
            torch.cuda.current_stream(dev).wait_stream(stream)
        if steps > warm:
            g = torch.cuda.CUDAGraph()
            opt.zero_grad(set_to_none=True)
            with torch.cuda.graph(g):
                step()
            for _ in range(steps - warm):  # the capture ran no step
                g.replay()
            torch.cuda.synchronize(dev)


def train_g2p(lexicon: Lexicon, win: int = 7, char_dim: int = 24, hidden: int = 384,
              dropout: float = 0.3, label_smooth: float = 0.1, steps: int = 1200,
              lr: float = 3e-3, weight_decay: float = 1e-3, align_iters: int = 3,
              seed: int = 0, ensemble: int = 3, bigram_weight: float = 0.0,
              bigram_smooth: float = 0.1, arch: str = "gru", gru_hidden: int = 64,
              device: tp.Union[str, torch.device, None] = None) -> G2P:
    """Align the lexicon, then train the per-grapheme chunk tagger, an
    ensemble of ``ensemble`` members (JAX's ``train_g2p``, same arguments and
    defaults); the G2P's lexicon is the whole of ``lexicon``. ``arch="gru"``
    tags whole words (padded with EOW, the loss masked to the letters);
    ``"mlp"`` tags ``win``-character windows. Trains on ``device`` (the GPU
    unless ``device="cpu"``), where the G2P then predicts."""
    dev = resolve_device(device)
    aligns = align_lexicon(lexicon, iters=align_iters)

    half = win // 2
    chars = sorted({c for _, w, _ in lexicon for c in w})
    cvocab = {c: i for i, c in enumerate(chars + [BOW, EOW, UNK_CHAR])}
    lvocab = {lang: i for i, lang in enumerate(sorted({lg.upper() for lg, _, _ in lexicon}))}

    chunk_ids: tp.Dict[tp.Tuple[str, ...], int] = {}
    rows, labels = [], []
    words_aligned: tp.List[tp.Tuple[str, str, tp.List[int]]] = []
    for (lang, w, _), chunks in zip(lexicon, aligns):
        if chunks is None:
            continue
        padded = BOW * half + w + EOW * half
        seq = []
        for i, ch in enumerate(chunks):
            rows.append([cvocab[padded[i + k]] for k in range(win)] + [lvocab[lang.upper()]])
            seq.append(chunk_ids.setdefault(ch, len(chunk_ids)))
        labels += seq
        words_aligned.append((lang.upper(), w, seq))
    if not rows:
        raise ValueError("no alignable entries in the lexicon")
    n_chars, n_langs, n_chunks = len(cvocab), len(lvocab), len(chunk_ids)

    # chunk-class bigram (add-k smoothed log-probs) for the Viterbi decode
    start = np.full(n_chunks, bigram_smooth, np.float64)
    trans = np.full((n_chunks, n_chunks), bigram_smooth, np.float64)
    for _, _, seq in words_aligned:
        start[seq[0]] += 1.0
        for a, b in zip(seq, seq[1:]):
            trans[a, b] += 1.0
    log_s = np.log(start / start.sum()).astype(np.float32)
    log_t = np.log(trans / trans.sum(1, keepdims=True)).astype(np.float32)

    def long(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    if arch == "gru":
        n_w, l_max = len(words_aligned), max(len(w) for _, w, _ in words_aligned)
        x = np.full((n_w, l_max), cvocab[EOW], np.int64)
        y = np.zeros((n_w, l_max), np.int64)
        mask = np.zeros((n_w, l_max), np.float32)
        for i, (_, w, seq) in enumerate(words_aligned):
            x[i, :len(w)] = [cvocab[c] for c in w]
            y[i, :len(w)] = seq
            mask[i, :len(w)] = 1.0
        x, y, lang_ids = long(x), long(y), long([lvocab[lg] for lg, _, _ in words_aligned])
        mask = torch.as_tensor(mask, device=dev)

        def loss_of(model: _Ensemble) -> torch.Tensor:
            logp = F.log_softmax(model(x, lang_ids), -1)  # (M, W, L, C)
            nll = -torch.gather(logp, -1, y.expand(len(model), -1, -1)[..., None])[..., 0]
            nll = (nll * mask).sum((1, 2)) / mask.sum()
            mean_lp = (logp.mean(-1) * mask).sum((1, 2)) / mask.sum()
            return ((1 - label_smooth) * nll - label_smooth * mean_lp).sum()
    else:
        x, y = long(rows), long(labels)

        def loss_of(model: _Ensemble) -> torch.Tensor:
            logp = F.log_softmax(model(x), -1)  # (M, N, C)
            nll = -torch.gather(logp, -1, y.expand(len(model), -1)[..., None]).mean((1, 2))
            return ((1 - label_smooth) * nll - label_smooth * logp.mean((1, 2))).sum()

    model = _Ensemble([init_tagger_params(np.random.default_rng(seed + 1000 * m), arch,
                                          n_chars, n_langs, n_chunks, char_dim, hidden, win,
                                          gru_hidden)
                       for m in range(max(1, ensemble))], arch, win, dropout).to(dev).train()
    _fit(model, loss_of, steps, lr, weight_decay, seed)
    members = model.member_params()

    chunk_symbols: tp.List[tp.Tuple[str, ...]] = [()] * n_chunks
    for ch, i in chunk_ids.items():
        chunk_symbols[i] = ch
    return G2P(cvocab, lvocab, chunk_symbols, members if len(members) > 1 else members[0],
               win=win, lexicon={(lg.upper(), w): pron for lg, w, pron in lexicon},
               bigrams=(log_s, log_t), bigram_weight=bigram_weight, arch=arch, device=dev)
