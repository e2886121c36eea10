"""Word-level prosody classifier (counterpart of
``speechflow_tpu/models/prosody/model.py``): word-token embeddings, a stack
of pre-LN transformer blocks (RoPE) over the valid words, a final LayerNorm
and two heads, binary (does the word carry a contour) and category (which
contour class).

``training=True`` drops at ``dropout``, and its blocks take the plain
attention with dropout on the weights; ``training=False``, the default as in
JAX, runs every block deterministically through ``fused_attention`` (the
CUDA kernel on a GPU tensor, with its VJP under autograd). The generic
``Trainer`` calls ``model(inputs)``, so the prosody model trains with the
default, as the JAX trainer trains it: without dropout (ROADMAP §3). The
weights start from flax's initialisers (``flax_init_``).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch
import torch.nn as nn

from speechflow_torch.models.layers import flax_init_, layer_norm
from speechflow_torch.models.tts.common import TransformerBlock
from speechflow_torch.training.base_model import BaseModelParams
from speechflow_torch.utils.masks import sequence_mask

__all__ = ["ProsodyModel", "ProsodyParams"]


@dataclasses.dataclass
class ProsodyParams(BaseModelParams):
    vocab_size: int = 8000
    n_classes: int = 8
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 4
    dropout: float = 0.1
    max_len: int = 128
    # "hash": the md5 hash vocabulary; "word_lm": the corpus vocabulary of a
    # WordLM trained by train_prosody, whose table warm-starts the embedding
    tokenizer: str = "hash"
    lm_epochs: int = 30


class ProsodyModel(nn.Module):
    def __init__(self, params: ProsodyParams):
        super().__init__()
        p = self.p = params
        self.emb = nn.Embedding(p.vocab_size, p.dim)
        self.blocks = nn.ModuleList(TransformerBlock(p.dim, p.n_heads, dropout=p.dropout)
                                    for _ in range(p.n_layers))
        self.norm = layer_norm(p.dim)
        self.binary_head = nn.Linear(p.dim, 2)
        self.category_head = nn.Linear(p.dim, p.n_classes)
        flax_init_(self)

    @torch.no_grad()
    def warmstart_embeddings(self, table: np.ndarray) -> None:
        """The first rows and columns of the token embedding from a WordLM
        table, rescaled to the current table's variance (rows and columns
        beyond it keep their values)."""
        cur = self.emb.weight.detach().cpu().numpy().copy()
        n = min(table.shape[0], cur.shape[0])
        d = min(table.shape[1], cur.shape[1])
        scale = np.sqrt(cur[:, :d].var() / max(float(np.var(table[:n, :d])), 1e-8))
        cur[:n, :d] = np.asarray(table)[:n, :d] * scale
        self.emb.weight.copy_(torch.from_numpy(cur))

    def forward(self, inputs: tp.Mapping[str, torch.Tensor],
                training: bool = False) -> tp.Dict[str, torch.Tensor]:
        """``inputs``: ``token_ids`` (B, T) and ``lengths`` (B,) -> logits
        ``binary`` (B, T, 2) and ``category`` (B, T, n_classes)."""
        ids, lens = inputs["token_ids"], inputs["lengths"]
        x = self.emb(ids)
        valid = sequence_mask(lens, ids.shape[1])
        for blk in self.blocks:
            x = blk(x, valid, deterministic=not training)
        x = self.norm(x)
        return {"binary": self.binary_head(x), "category": self.category_head(x)}
