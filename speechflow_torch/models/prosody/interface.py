"""Prosody prediction at inference (counterpart of
``speechflow_tpu/models/prosody/interface.py``): words -> token ids (the
trained WordLM vocabulary a checkpoint's payload carries as
``word_lm_vocab``, else the md5 hash vocabulary) -> per-word contour class.

Two ways in: ``ProsodyPredictionInterface(ckpt_path)`` reads a checkpoint
directory of either package's trainer (``scripts/train_prosody.py`` writes one;
the JAX trainer's orbax one too);
``from_checkpoint(tree, payload)`` takes what a checkpoint loader returns,
the JAX ``ExperimentSaver.load_checkpoint`` included. The model runs on the
GPU unless ``device="cpu"``; a sentence of n words is one row padded to a
multiple of 16 tokens.
"""

from __future__ import annotations

import hashlib
import typing as tp
from pathlib import Path

import numpy as np
import torch

from speechflow_torch.convert import load_nnx_state
from speechflow_torch.models.prosody.model import ProsodyModel, ProsodyParams
from speechflow_torch.utils.device import resolve_device

__all__ = ["ProsodyPredictionInterface", "hash_tokenize", "word_ids"]

TOKEN_MULTIPLE = 16


def hash_tokenize(words: tp.Sequence[str], vocab_size: int = 8000) -> np.ndarray:
    """Ids 1..vocab_size-1 from the md5 of each lowercased word (0 is PAD)."""
    ids = []
    for w in words:
        h = int(hashlib.md5(w.lower().encode()).hexdigest()[:8], 16)
        ids.append(1 + h % (vocab_size - 1))
    return np.asarray(ids, np.int32)


def word_ids(words: tp.Sequence[str], vocab: tp.Optional[tp.Mapping[str, int]],
             vocab_size: int = 8000) -> np.ndarray:
    """Token ids of ``words``: a WordLM vocabulary's (lowercased, 0 out of it)
    when there is one, else ``hash_tokenize``'s."""
    if vocab is not None:
        return np.asarray([vocab.get(w.lower(), 0) for w in words], np.int32)
    return hash_tokenize(words, vocab_size)


class ProsodyPredictionInterface:
    def __init__(self, ckpt_path: tp.Union[str, Path],
                 device: tp.Union[str, torch.device, None] = None):
        """The last state of a port checkpoint directory on ``device``."""
        from speechflow_torch.training.saver import ExperimentSaver

        dev = resolve_device(device)
        self._build(*ExperimentSaver.load_checkpoint(ckpt_path), dev)

    @classmethod
    def from_checkpoint(cls, tree: tp.Mapping, payload: tp.Mapping,
                        device: tp.Union[str, torch.device, None] = None
                        ) -> "ProsodyPredictionInterface":
        """From ``(tree, payload)`` of a checkpoint (``tree["model"]`` an nnx pure
        dict), on ``device`` (the GPU unless ``device="cpu"``)."""
        dev = resolve_device(device)
        self = cls.__new__(cls)
        self._build(tree, payload, dev)
        return self

    def _build(self, tree: tp.Mapping, payload: tp.Mapping, device: torch.device) -> None:
        self.params = ProsodyParams.create(payload["model_params"])
        self.model = load_nnx_state(ProsodyModel(self.params), tree["model"]).to(device).eval()
        self.device = device
        self.vocab: tp.Optional[dict] = payload.get("word_lm_vocab")

    def tokenize(self, words: tp.Sequence[str]) -> np.ndarray:
        return word_ids(words, self.vocab, self.params.vocab_size)

    @torch.inference_mode()
    def logits(self, words: tp.Sequence[str]) -> tp.Dict[str, torch.Tensor]:
        """The heads' logits (1, T, C) of one sentence, T = n words rounded up
        to a multiple of 16."""
        ids = self.tokenize(words)
        n = len(ids)
        batch = {"token_ids": torch.from_numpy(np.pad(ids, (0, (-n) % TOKEN_MULTIPLE))[None]
                                               ).to(self.device),
                 "lengths": torch.tensor([n], dtype=torch.int32, device=self.device)}
        return self.model(batch, training=False)

    def predict(self, words: tp.Sequence[str]) -> tp.Dict[str, np.ndarray]:
        """Per word: ``has_contour`` (0/1) and ``category`` (the argmax class)."""
        n = len(words)
        out = self.logits(words)
        return {"has_contour": out["binary"].argmax(-1)[0, :n].cpu().numpy().astype(np.int32),
                "category": out["category"].argmax(-1)[0, :n].cpu().numpy().astype(np.int32)}
