"""Experiment checkpoints, the half after the restore (counterpart of
``speechflow_tpu/training/saver.py:114-187``).

The JAX trainer writes a checkpoint directory ``step_<N>`` holding the
state tree (orbax, OCDBT with zstd-compressed chunks) and ``payload.pkl``
(the params, pipeline info and versions an eval interface rebuilds from).
The port cannot read the tree files: that needs an OCDBT reader in the
repository. It starts from what the JAX loader returns, ``(tree, payload)``,
and keeps the plain-dict and pickle work that follows: finding the last
checkpoint, reading the payload, and migrating legacy state layouts.
"""

from __future__ import annotations

import pickle
import re
import typing as tp
from pathlib import Path

__all__ = ["ExperimentSaver"]

_DECODER_KEYS = ("dec_pre", "dec", "dec_post")


class ExperimentSaver:
    @staticmethod
    def get_last_checkpoint(expr_or_ckpt_dir: tp.Union[str, Path]) -> tp.Optional[Path]:
        """The ``step_*`` directory with the highest step, under an experiment
        directory or its ``checkpoints`` directory; None if there is none."""
        d = Path(expr_or_ckpt_dir)
        if (d / "checkpoints").is_dir():
            d = d / "checkpoints"
        cands = [p for p in d.glob("step_*") if p.is_dir()]

        def step_of(p: Path) -> int:
            m = re.match(r"step_(\d+)", p.name)
            return int(m.group(1)) if m else -1

        return max(cands, key=step_of) if cands else None

    @staticmethod
    def load_payload(ckpt_path: tp.Union[str, Path]) -> dict:
        """A checkpoint's ``payload.pkl`` ({} if it has none). Unpickling runs
        code: read only checkpoints this project's trainers wrote."""
        f = Path(ckpt_path) / "payload.pkl"
        return pickle.loads(f.read_bytes()) if f.exists() else {}

    @staticmethod
    def remap_legacy_keys(model: dict) -> dict:
        """Migrate state dicts saved before two refactors of the JAX package
        (in place, and returned): a NeuralCodec's inline decoder
        (``dec_pre``/``dec``/``dec_post`` beside other submodules) nests under
        ``decoder``; a ``SnakeUpsampleHead``'s pre-MRF ``resblocks.N`` (a
        ResBlock) becomes ``resblocks.N.0``."""
        if not isinstance(model, dict):
            return model

        def fix_codec(node):
            if not isinstance(node, dict):
                return node
            for k, v in list(node.items()):
                node[k] = fix_codec(v)
            # a CodecDecoder itself holds dec_* only: wrap just a legacy root
            has_dec = set(_DECODER_KEYS) & set(node)
            has_others = bool(set(node) - set(_DECODER_KEYS))
            if has_dec and has_others and "decoder" not in node:
                node["decoder"] = {k: node.pop(k) for k in _DECODER_KEYS if k in node}
            return node

        def fix_resblocks(node):
            if not isinstance(node, dict):
                return node
            rb = node.get("resblocks")
            if isinstance(rb, dict) and rb and all(
                    isinstance(v, dict) and {"convs", "acts"} <= set(v) for v in rb.values()):
                node["resblocks"] = {k: {"0": v} for k, v in rb.items()}
            for k, v in list(node.items()):
                if k != "resblocks":
                    node[k] = fix_resblocks(v)
            return node

        return fix_resblocks(fix_codec(model))
