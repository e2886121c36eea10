"""Prosody-model training (counterpart of ``speechflow_tpu/scripts/train_prosody.py``).

Trains the word-level contour classifier (``models/prosody``) on the
TextGrid files of a corpus: the words of each file's text tier and the
targets of its ``prosody`` tier (``data.parsers.prosody_targets``). With
``tokenizer: word_lm`` (the recipe's, default and debug) a WordLM is trained on the corpus text
first (``models/prosody/lm.py``, on the same device), saved as
``word_lm.pkl`` in the experiment directory, its vocabulary stored in the
checkpoint payload as ``word_lm_vocab`` (the prosody interface tokenizes
with it), and its table warm-starts the token embedding. Then the generic
``Trainer`` fits the model with AdamW on WarmupCosine. It calls
``model(inputs)``, as the JAX trainer does, which is the prosody model's
deterministic call: no dropout, and the blocks' attention through
``fused_attention`` (the kernel and its VJP on the GPU).

``-c`` reads any YAML model config (default ``configs/prosody_model.yml``),
``-cd`` any data config, whose ``dirs.data_root`` is the corpus unless
``--data_root`` is given (default ``configs/tts_data_24khz.yml``); ``-vs``
takes the selectors of their ``value_select``.

    python -m speechflow_torch.scripts.train_prosody -vs debug --device cpu --max_steps 4
    python -m speechflow_torch.scripts.train_prosody            # on the GPU, default preset

It runs on the GPU unless ``--device cpu``; weights start from
``torch.manual_seed(trainer.seed)``.
"""

from __future__ import annotations

import dataclasses
import logging
import typing as tp
from pathlib import Path

import numpy as np
import torch

from speechflow_torch.data.parsers import prosody_targets, seg_prosody_labels
from speechflow_torch.io.flist import construct_file_list
from speechflow_torch.io.seg import AudioSeg
from speechflow_torch.models.prosody import ProsodyCriterion, ProsodyModel, ProsodyParams
from speechflow_torch.models.prosody.interface import word_ids
from speechflow_torch.models.prosody.lm import train_word_lm
from speechflow_torch.scripts.common import (
    configs_of_args,
    experiment_saver,
    optimizer_config,
    read_configs,
    train_arguments,
    trainer_config,
)
from speechflow_torch.scripts.train_tts import DATA_CONFIG
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.training.trainer import Trainer
from speechflow_torch.utils.device import resolve_device

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["MODEL_CONFIG", "ProsodySampleLoader", "prosody_batch", "configs", "train",
           "main", "cli"]

MODEL_CONFIG = "configs/prosody_model.yml"


class ProsodySampleLoader:
    """Batches of (token ids, lengths, binary and category targets) from the
    words and prosody tiers of a corpus's TextGrid files, rows drawn with
    replacement from ``np.random.default_rng(seed)``, each cut to ``max_len``
    words and padded (ids 0, targets -1)."""

    def __init__(self, data_root: str, vocab_size: int, batch_size: int = 16,
                 max_len: int = 64, seed: int = 0):
        self.items: tp.List[tp.Tuple[tp.List[str], tp.Optional[tp.List[str]]]] = []
        for f in construct_file_list(data_root, ext=".TextGridStage3"):
            seg = AudioSeg.load(f)
            words = [w for _, _, w in seg.words()]
            if words:
                self.items.append((words, seg_prosody_labels(seg, len(words))))
        if not self.items:
            raise ValueError(f"no TextGrid file with words under {data_root}")
        self.vocab_size = vocab_size
        self.batch_size = batch_size
        self.max_len = max_len
        self.rng = np.random.default_rng(seed)
        self.vocab: tp.Optional[dict] = None

    def set_vocab(self, vocab: dict) -> None:
        """Token ids from a trained WordLM vocabulary (0 out of it) instead of
        the hash vocabulary."""
        self.vocab = vocab

    def next_batch(self) -> tp.Dict[str, np.ndarray]:
        idx = self.rng.integers(0, len(self.items), self.batch_size)
        ids = np.zeros((self.batch_size, self.max_len), np.int32)
        binary = np.full((self.batch_size, self.max_len), -1, np.int32)
        category = np.full((self.batch_size, self.max_len), -1, np.int32)
        lens = np.zeros((self.batch_size,), np.int32)
        for r, i in enumerate(idx):
            words, prosody = self.items[int(i)]
            n = min(len(words), self.max_len)
            ids[r, :n] = word_ids(words[:n], self.vocab, self.vocab_size)
            lens[r] = n
            b, c = prosody_targets(words[:n], prosody[:n] if prosody else None)
            binary[r, :n] = b
            category[r, :n] = c
        return {"token_ids": ids, "lengths": lens, "binary": binary, "category": category}


def prosody_batch(batch: tp.Mapping) -> tp.Tuple[dict, dict]:
    """A loader batch -> (the model's inputs, the criterion's targets)."""
    return ({"token_ids": batch["token_ids"], "lengths": batch["lengths"]},
            {"binary": batch["binary"], "category": batch["category"]})


def configs(value_select: tp.Union[str, tp.Sequence[str], None] = "default",
            model_config: tp.Union[str, Path] = MODEL_CONFIG,
            data_config: tp.Union[str, Path] = DATA_CONFIG,
            data_root: tp.Union[str, Path, None] = None) -> tp.Tuple[dict, dict]:
    """(model config, data config) read from the YAML files with
    ``value_select``: fresh dicts; the data config gives the corpus
    (``dirs.data_root``)."""
    return read_configs(model_config, data_config, value_select, data_root)


def train(model_cfg: tp.Mapping, data_root: tp.Union[str, Path], saver: ExperimentSaver,
          device: tp.Union[str, torch.device, None] = None,
          callbacks: tp.Sequence[tp.Callable] = ()) -> str:
    """Build the loader, the WordLM (``tokenizer: word_lm``) and the model on
    ``device`` (the GPU unless ``"cpu"``) and fit; returns the experiment
    directory."""
    dev = resolve_device(device)
    cfg = trainer_config(model_cfg)
    params = ProsodyParams.create(model_cfg["model"])
    torch.manual_seed(cfg.seed)
    model = ProsodyModel(params).to(dev)
    saver.to_save["model_params"] = dataclasses.asdict(params)
    loader = ProsodySampleLoader(str(data_root), params.vocab_size,
                                 batch_size=int((model_cfg.get("batch") or {}).get("size", 16)))
    if params.tokenizer == "word_lm":
        texts = [" ".join(words) for words, _ in loader.items]
        lm = train_word_lm(texts, dim=min(params.dim, 64), max_vocab=params.vocab_size - 1,
                           epochs=params.lm_epochs, device=dev)
        lm.save(saver.expr_path / "word_lm.pkl")
        saver.to_save["word_lm_vocab"] = lm.vocab
        model.warmstart_embeddings(lm.embeddings)
        loader.set_vocab(lm.vocab)
        LOGGER.info("word LM trained: %d words in vocab", len(lm.vocab))
    trainer = Trainer(model, ProsodyCriterion(), prosody_batch, optimizer_config(model_cfg),
                      cfg, saver=saver)
    last = trainer.fit(loader, callbacks=callbacks)
    LOGGER.info("prosody training done: %s", last)
    return str(saver.expr_path)


def main(argv=None) -> str:
    args = train_arguments("training of the prosody model", MODEL_CONFIG,
                           DATA_CONFIG).parse_args(argv)
    model_cfg, data_cfg = configs_of_args(args)
    saver = experiment_saver(model_cfg, data_cfg, args.experiment_dir)
    return train(model_cfg, data_cfg["dirs"]["data_root"], saver, device=args.device)


def cli() -> None:
    """Console entry point: exit-code semantics want None."""
    main()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
