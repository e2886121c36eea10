"""Word-embedding language model trained on the corpus (counterpart of
``speechflow_tpu/models/prosody/lm.py``): skip-gram with negative sampling
over words (``train_word_lm``) or any token sequences (``train_token_lm``),
and ``WordLM``, a vocabulary with its embedding table and a char-trigram
out-of-vocabulary vector. ``save`` / ``load`` use the JAX package's pickle,
so either package reads the other's ``word_lm.pkl``.

Training takes the JAX script's draws from ``np.random.default_rng(seed)`` in
its order (the input table, then per epoch the permutation and per step the
negatives), so a seed gives JAX's table up to f32 rounding. Each step is one
SGD step on the SGNS loss in PyTorch on ``device`` (the GPU unless
``device="cpu"``): gathers of the two tables, log-sigmoid terms, and the
gathers' backward, which sums the gradients of repeated ids as JAX's does.
"""

from __future__ import annotations

import hashlib
import pickle
import re
import typing as tp
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from speechflow_torch.utils.device import resolve_device

__all__ = ["WordLM", "train_word_lm", "train_token_lm", "tokenize_words"]

_WORD_RE = re.compile(r"[\w']+", re.UNICODE)


def tokenize_words(text: str) -> tp.List[str]:
    return [w.lower() for w in _WORD_RE.findall(text)]


class WordLM:
    """Vocabulary (word -> row; 0 is OOV/PAD) and its embedding table."""

    def __init__(self, vocab: tp.Dict[str, int], embeddings: np.ndarray):
        self.vocab = vocab
        self.embeddings = np.asarray(embeddings).astype(np.float32)
        self.dim = self.embeddings.shape[1]

    def _oov_vector(self, word: str) -> np.ndarray:
        """The sum of the rows its char trigrams hash to (blake2s), over
        sqrt(#trigrams)."""
        grams = [word[i:i + 3] for i in range(max(len(word) - 2, 1))]
        vec = np.zeros(self.dim, np.float32)
        n_rows = len(self.embeddings)
        for g in grams:
            h = int.from_bytes(hashlib.blake2s(g.encode(), digest_size=4).digest(), "little")
            vec += self.embeddings[h % n_rows]
        return vec / np.sqrt(max(len(grams), 1))

    def embed(self, words: tp.Sequence[str]) -> np.ndarray:
        """(n, dim) L2-normalised rows (OOV words by ``_oov_vector``)."""
        out = np.zeros((len(words), self.dim), np.float32)
        for i, w in enumerate(words):
            w = w.lower()
            idx = self.vocab.get(w)
            out[i] = self.embeddings[idx] if idx is not None else self._oov_vector(w)
        norms = np.linalg.norm(out, axis=-1, keepdims=True)
        return out / np.maximum(norms, 1e-9)

    def token_ids(self, words: tp.Sequence[str], oov_id: int = 0) -> np.ndarray:
        return np.asarray([self.vocab.get(w.lower(), oov_id) for w in words], np.int32)

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.embed([a])[0], self.embed([b])[0]
        return float(va @ vb)

    def save(self, path: tp.Union[str, Path]) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"vocab": self.vocab, "embeddings": self.embeddings}, f)
        return path

    @classmethod
    def load(cls, path: tp.Union[str, Path]) -> "WordLM":
        """A pickle this project wrote (unpickling runs code)."""
        with open(path, "rb") as f:
            tree = pickle.load(f)
        return cls(tree["vocab"], tree["embeddings"])


def train_word_lm(texts: tp.Iterable[str], dim: int = 32, window: int = 3,
                  min_count: int = 1, max_vocab: int = 20000, n_negatives: int = 8,
                  epochs: int = 60, batch_size: int = 1024, lr: float = 0.05, seed: int = 0,
                  device: tp.Union[str, torch.device, None] = None) -> WordLM:
    """``train_token_lm`` over the texts' lowercased words."""
    return train_token_lm([tokenize_words(t) for t in texts], dim=dim, window=window,
                          min_count=min_count, max_vocab=max_vocab, n_negatives=n_negatives,
                          epochs=epochs, batch_size=batch_size, lr=lr, seed=seed,
                          device=device)


def train_token_lm(sentences: tp.Sequence[tp.Sequence[str]], dim: int = 32, window: int = 3,
                   min_count: int = 1, max_vocab: int = 20000, n_negatives: int = 8,
                   epochs: int = 60, batch_size: int = 1024, lr: float = 0.05, seed: int = 0,
                   device: tp.Union[str, torch.device, None] = None) -> WordLM:
    """Skip-gram with negative sampling over token sequences: the (center,
    context) pairs within ``window``, negatives from unigram^0.75, one SGD step
    a batch of pairs, ``epochs`` passes. Returns the input table as a WordLM."""
    dev = resolve_device(device)
    sentences = [[str(w).lower() for w in s] for s in sentences]
    counts = Counter(w for s in sentences for w in s)
    words = [w for w, c in counts.most_common(max_vocab) if c >= min_count]
    vocab = {w: i + 1 for i, w in enumerate(words)}  # 0 = OOV/PAD
    v = len(vocab) + 1

    centers, contexts = [], []
    for s in sentences:
        ids = [vocab.get(w, 0) for w in s]
        for i, c in enumerate(ids):
            if c == 0:
                continue
            for j in range(max(0, i - window), min(len(ids), i + window + 1)):
                if j != i and ids[j] != 0:
                    centers.append(c)
                    contexts.append(ids[j])
    if not centers:
        return WordLM(vocab, np.zeros((v, dim), np.float32))
    centers = np.asarray(centers, np.int64)
    contexts = np.asarray(contexts, np.int64)

    freq = np.zeros(v, np.float64)
    for w, i in vocab.items():
        freq[i] = counts[w]
    neg_p = freq ** 0.75
    neg_p = neg_p / neg_p.sum()

    rng = np.random.default_rng(seed)
    emb_in = (rng.standard_normal((v, dim)) / np.sqrt(dim)).astype(np.float32)
    e_in = torch.from_numpy(emb_in).to(dev).requires_grad_()
    e_out = torch.zeros((v, dim), device=dev, requires_grad=True)
    centers_d = torch.from_numpy(centers).to(dev)
    contexts_d = torch.from_numpy(contexts).to(dev)

    n_pairs = len(centers)
    steps_per_epoch = max(n_pairs // batch_size, 1)
    for _ in range(epochs):
        perm = rng.permutation(n_pairs)
        for s in range(steps_per_epoch):
            idx = perm[s * batch_size:(s + 1) * batch_size]
            if len(idx) < 8:
                continue
            negs = rng.choice(v, size=(len(idx), n_negatives), p=neg_p)
            idx_d = torch.from_numpy(idx).to(dev)
            vc = e_in[centers_d[idx_d]]                         # (B, D)
            vo = e_out[contexts_d[idx_d]]                       # (B, D)
            vn = e_out[torch.from_numpy(negs).to(dev)]          # (B, K, D)
            pos = F.logsigmoid((vc * vo).sum(-1))
            neg = F.logsigmoid(-torch.einsum("bd,bkd->bk", vc, vn)).sum(-1)
            loss = -(pos + neg).mean()
            g_in, g_out = torch.autograd.grad(loss, (e_in, e_out))
            with torch.no_grad():
                e_in -= lr * g_in
                e_out -= lr * g_out
    return WordLM(vocab, e_in.detach().cpu().numpy())
