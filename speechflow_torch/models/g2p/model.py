"""Grapheme-to-phoneme inference (counterpart of
``speechflow_tpu/models/g2p/model.py``: ``G2P.load``, ``predict``).

A ``g2p.pkl`` holds the char and language vocabularies, the phoneme-chunk
inventory, the mined lexicon, optional chunk-class bigrams, and the tagger's
parameters: one tree, or a list of them (a seed ensemble whose log-softmax
outputs are averaged). ``predict`` is lexicon-first; the other words go
through the tagger (``arch="gru"``: a bidirectional GRU over the whole word;
``"mlp"``: a window MLP over ``win`` characters), one batched forward on the
G2P's device, then per word a Viterbi pass over the bigrams (when
``bigram_weight > 0``) or the argmax, and the chunks are concatenated.

The trainer pickles the parameters as numpy arrays, and the port reads only
numpy leaves: a pickle whose leaves are JAX arrays needs JAX to load.
Training waits for a later slice; its starting point is ported:
``init_tagger_params`` draws a fresh tagger as the JAX trainer does (numpy's
generator, not flax's initialisers: the tagger is a plain parameter tree).
"""

from __future__ import annotations

import pickle
import re
import typing as tp
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.utils.device import resolve_device

__all__ = ["G2P", "init_tagger_params", "normalize_word"]

_WORD_CLEAN_RE = re.compile(r"[^\w']+", re.UNICODE)
BOW, EOW, UNK_CHAR = "<", ">", "\0"   # window boundary / unknown-char markers


def normalize_word(word: str) -> str:
    return _WORD_CLEAN_RE.sub("", word.lower())


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


class _Tagger(nn.Module):
    """One ensemble member: its parameter tree as fixed float32 tensors.
    ``jax.nn.gelu``, which the trainer used, is the tanh form."""

    def __init__(self, params: tp.Mapping[str, np.ndarray], arch: str, win: int):
        super().__init__()
        self.arch, self.win = arch, win
        self.p = nn.ParameterDict({
            k: nn.Parameter(torch.from_numpy(np.array(v, np.float32)), requires_grad=False)
            for k, v in params.items()})

    def _gru_dir(self, e: torch.Tensor, prefix: str, reverse: bool) -> torch.Tensor:
        p = self.p
        h = e.new_zeros(e.shape[0], p[prefix + "Uz"].shape[0])
        out = [None] * e.shape[1]
        for t in (reversed(range(e.shape[1])) if reverse else range(e.shape[1])):
            x_t = e[:, t]
            z = torch.sigmoid(x_t @ p[prefix + "Wz"] + h @ p[prefix + "Uz"] + p[prefix + "bz"])
            r = torch.sigmoid(x_t @ p[prefix + "Wr"] + h @ p[prefix + "Ur"] + p[prefix + "br"])
            n = torch.tanh(x_t @ p[prefix + "Wn"] + (r * h) @ p[prefix + "Un"] + p[prefix + "bn"])
            h = (1 - z) * n + z * h
            out[t] = h
        return torch.stack(out, dim=1)

    def forward(self, x: torch.Tensor, lang_ids: tp.Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``gru``: x (B, L) char ids, lang_ids (B,) -> (B, L, n_chunks);
        ``mlp``: x (N, win+1) window ids + a lang id -> (N, n_chunks)."""
        p = self.p
        if self.arch == "gru":
            e = p["ce"][x] + p["le"][lang_ids][:, None, :]
            h = torch.cat([self._gru_dir(e, "f_", False), self._gru_dir(e, "b_", True)], -1)
            h = F.gelu(h @ p["w1"] + p["b1"], approximate="tanh")
        else:
            h = torch.cat([p["ce"][x[:, :self.win]].reshape(x.shape[0], -1),
                           p["le"][x[:, self.win]]], -1)
            h = F.gelu(h @ p["w1"] + p["b1"], approximate="tanh")
            h = F.gelu(h @ p["w2"] + p["b2"], approximate="tanh")
        return h @ p["wo"] + p["bo"]


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
        members = list(params) if isinstance(params, (list, tuple)) else [params]
        self.device = resolve_device(device)
        self.members = nn.ModuleList(_Tagger(m, arch, win) for m in members).to(self.device)

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
        lp = sum(F.log_softmax(m(*args), -1) for m in self.members) / len(self.members)
        lp = lp.float().cpu().numpy()
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

    @classmethod
    def load(cls, path: tp.Union[str, Path],
             device: tp.Union[str, torch.device, None] = None) -> "G2P":
        """A ``g2p.pkl`` written by the JAX ``G2P.save``. Unpickling runs
        code: read only files this project's trainer wrote."""
        with open(path, "rb") as f:
            tree = pickle.load(f)
        return cls(tree["cvocab"], tree["lvocab"], tree["chunk_symbols"], tree["params"],
                   tree.get("win", 7), tree.get("lexicon"), bigrams=tree.get("bigrams"),
                   bigram_weight=tree.get("bigram_weight", 0.0),
                   arch=tree.get("arch", "mlp"), device=device)
