"""Experiment directories and checkpoints (counterpart of
``speechflow_tpu/training/saver.py``).

An experiment directory (``<base>/<stamp>_<name>``) holds the data and model
config text and ``checkpoints/step_<N:09d>/``, as the JAX saver lays it out.
A checkpoint directory the port writes holds:

- ``model.npz``: the model tree in the JAX package's pure-dict layout
  (``convert.nnx_from_module``), one array per leaf under its ``/``-joined
  path, and the step;
- ``opt.pt``: the port's optimizer states (``torch.save``), if any;
- ``payload.pkl``: the same payload the JAX saver pickles (versions, the
  configs' text, pipeline info, model params, anything in ``to_save``).

``load_checkpoint`` reads that layout and the JAX saver's: orbax OCDBT with
zstd-compressed zarr chunks (``io.orbax``, no orbax or tensorstore needed),
and returns ``(tree, payload)`` as the JAX loader does (``tree = {"model",
"step", "opt"}``, ``remap_legacy_keys`` applied), so the eval interfaces,
finetuning and warm starts take a checkpoint of either package; the trainers
resume either (the ``opt`` of a JAX checkpoint is optax's state, which
``training.optax_state`` maps), and ``resumable`` refuses a checkpoint that
holds no optimizer state.

``filter_state_by_prefix`` and ``merge_states`` serve finetuning and
warm starts (``scripts.common.apply_resume_warmstart``): they work on that
pure-dict tree and match the ``/``-joined JAX paths, so a recipe's
``warmstart.include`` selects the same tensors in both packages.
"""

from __future__ import annotations

import importlib
import io
import os
import pickle
import re
import shutil
import subprocess
import sys
import time
import typing as tp
from pathlib import Path

import numpy as np

from speechflow_torch.io import orbax

__all__ = ["ExperimentSaver", "is_checkpoint", "load_pickle", "UnmappedClassError"]


class UnmappedClassError(pickle.UnpicklingError):
    """A pickle names a class of the JAX package the port has no counterpart of."""


class _PortUnpickler(pickle.Unpickler):
    """Reads a pickle the JAX package wrote: a class of ``speechflow_tpu.<m>``
    is taken from ``speechflow_torch.<m>`` under the same name, and raises by
    name where the port has no counterpart (the JAX package is never
    imported)."""

    def find_class(self, module: str, name: str):
        if module == "speechflow_tpu" or module.startswith("speechflow_tpu."):
            port = "speechflow_torch" + module[len("speechflow_tpu"):]
            try:
                return getattr(importlib.import_module(port), name)
            except (ImportError, AttributeError) as e:
                raise UnmappedClassError(
                    f"{module}.{name}: the pickle names a class of the JAX package that "
                    f"has no counterpart {port}.{name} in the port") from e
        return super().find_class(module, name)


def load_pickle(data: bytes):
    """Unpickle bytes this project wrote (either package); unpickling runs
    code, so never read a pickle of unknown origin."""
    return _PortUnpickler(io.BytesIO(data)).load()


def is_checkpoint(path: tp.Union[str, Path]) -> bool:
    """Whether ``path`` is a checkpoint directory of either package."""
    p = Path(path)
    return (p / "model.npz").is_file() or orbax.is_orbax_checkpoint(p)

_DECODER_KEYS = ("dec_pre", "dec", "dec_post")


def _flatten(tree: tp.Mapping, prefix: str = "") -> tp.Dict[str, np.ndarray]:
    out: tp.Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, tp.Mapping):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: tp.Mapping[str, np.ndarray]) -> dict:
    """``/``-joined keys -> nested dicts; digit keys become ints, as list
    indices are in an nnx pure dict."""
    out: dict = {}
    for key, v in flat.items():
        parts = [int(k) if k.isdigit() else k for k in key.split("/")]
        node = out
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return out


class ExperimentSaver:
    def __init__(self, experiment_path: tp.Union[str, Path], expr_suffix: str = "",
                 dump_sources: bool = False, source_root: tp.Optional[Path] = None):
        """With ``dump_sources`` the payload's ``sources`` holds the text of every
        ``.py``, ``.yml`` and ``.md`` file under ``source_root`` (default: the
        working directory), as the JAX saver's does."""
        stamp = time.strftime("%Y%m%d_%H%M%S")
        name = f"{stamp}{'_' + expr_suffix if expr_suffix else ''}"
        self.expr_path = Path(experiment_path) / name
        # a second experiment started in the same second gets its own directory (JAX's
        # would share the first's)
        k = 1
        while self.expr_path.exists():
            k += 1
            self.expr_path = Path(experiment_path) / f"{name}_{k}"
        self.ckpt_dir = self.expr_path / "checkpoints"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.to_save: tp.Dict[str, tp.Any] = {"versions": self._versions(),
                                              "git_commit": self._git_commit()}
        if dump_sources:
            self.to_save["sources"] = self._dump_sources(Path(source_root or Path.cwd()))

    @staticmethod
    def _dump_sources(root: Path) -> tp.Dict[str, str]:
        """Relative path -> text of the ``.py``, ``.yml`` and ``.md`` files under
        ``root``, hidden directories, ``__pycache__`` and ``experiments`` left
        out (an unreadable file too)."""
        out = {}
        for ext in ("*.py", "*.yml", "*.md"):
            for p in root.rglob(ext):
                if any(part.startswith(".") or part in ("__pycache__", "experiments")
                       for part in p.parts):
                    continue
                try:
                    out[str(p.relative_to(root))] = p.read_text(encoding="utf-8")
                except (OSError, UnicodeDecodeError):
                    pass
        return out

    @staticmethod
    def _versions() -> dict:
        import torch

        return {"python": sys.version.split()[0], "torch": torch.__version__,
                "numpy": np.__version__}

    @staticmethod
    def _git_commit() -> tp.Optional[str]:
        """HEAD of the checkout this module lies in, or None outside a git tree."""
        try:
            out = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                                 text=True, timeout=5, cwd=Path(__file__).resolve().parent)
        except (OSError, subprocess.SubprocessError):
            return None
        if out.returncode != 0:
            return None
        return out.stdout.strip() or None

    def save_configs(self, data_cfg_text: tp.Optional[str] = None,
                     model_cfg_text: tp.Optional[str] = None) -> None:
        """Write the configs' text beside the checkpoints and into the payload."""
        if data_cfg_text is not None:
            (self.expr_path / "data.yml").write_text(data_cfg_text)
            self.to_save["data_config_text"] = data_cfg_text
        if model_cfg_text is not None:
            (self.expr_path / "model.yml").write_text(model_cfg_text)
            self.to_save["model_config_text"] = model_cfg_text

    def save(self, step: int, model_state: tp.Mapping, opt_state: tp.Any = None,
             extra: tp.Optional[dict] = None) -> Path:
        """Write ``step_<N>``; a step already saved is left as it is (the same
        step is the same state). Written into a temporary directory first, so
        a checkpoint directory is whole or absent."""
        path = self.ckpt_dir / f"step_{step:09d}"
        if path.exists():
            return path
        payload = dict(self.to_save)
        payload.update(extra or {})
        return ExperimentSaver.write_checkpoint(path, step, model_state, opt_state, payload)

    @staticmethod
    def write_checkpoint(path: tp.Union[str, Path], step: int, model_state: tp.Mapping,
                         opt_state: tp.Any, payload: tp.Mapping) -> Path:
        """A checkpoint directory in the port's layout at ``path`` (replacing one
        there), written into a temporary directory first, so it is whole or absent."""
        import torch

        path = Path(path)
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        flat = {f"model/{k}": v for k, v in _flatten(model_state).items()}
        np.savez(tmp / "model.npz", step=np.asarray(step), **flat)
        if opt_state is not None:
            torch.save(opt_state, tmp / "opt.pt")
        (tmp / "payload.pkl").write_bytes(pickle.dumps(dict(payload), protocol=5))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        return path

    @staticmethod
    def load_checkpoint(path: tp.Union[str, Path]) -> tp.Tuple[dict, dict]:
        """``(tree, payload)`` of a checkpoint of either package:
        ``tree["model"]`` is the pure-dict model tree (legacy layouts
        migrated), ``tree["step"]`` the step, ``tree["opt"]`` the optimizer
        states (the port's torch states, or a JAX checkpoint's optax tree) or
        None. An orbax checkpoint's tree is what the JAX loader returns (dict
        keys as strings, the step a 0-d array). Unpickling runs code: load only
        checkpoints this project's trainers wrote."""
        import torch

        path = Path(path)
        if orbax.is_orbax_checkpoint(path):
            tree = orbax.read_tree(path)
            if isinstance(tree, dict) and "model" in tree:
                tree["model"] = ExperimentSaver.remap_legacy_keys(tree["model"])
            return tree, ExperimentSaver.load_payload(path)
        if not (path / "model.npz").exists():
            raise FileNotFoundError(f"{path}: neither model.npz (a checkpoint of the port) "
                                    "nor _METADATA (an orbax checkpoint of the JAX package)")
        with np.load(path / "model.npz") as z:
            flat = {k[len("model/"):]: z[k] for k in z.files if k.startswith("model/")}
            step = int(z["step"])
        opt_file = path / "opt.pt"
        opt = torch.load(opt_file, map_location="cpu", weights_only=False) \
            if opt_file.exists() else None
        tree = {"model": ExperimentSaver.remap_legacy_keys(_unflatten(flat)), "step": step,
                "opt": opt}
        return tree, ExperimentSaver.load_payload(path)

    @staticmethod
    def resumable(path: tp.Union[str, Path]) -> Path:
        """``path``, when a trainer can resume from it: it holds the optimizer
        state (the port's ``opt.pt``, or a JAX checkpoint's ``opt`` tree);
        ``ValueError`` for one that holds only weights, whose moments a resume
        would restart from zero."""
        path = Path(path)
        has_opt = ("opt" in orbax.top_keys(path) if orbax.is_orbax_checkpoint(path)
                   else (path / "opt.pt").is_file())
        if not has_opt:
            raise ValueError(
                f"{path} holds no optimizer state: resuming would restart the moments from "
                "zero. Start from its weights with finetune.ckpt or warmstart.ckpt (-w)")
        return path

    @staticmethod
    def get_last_checkpoint(expr_or_ckpt_dir: tp.Union[str, Path]) -> tp.Optional[Path]:
        """The ``step_*`` directory with the highest step, under an experiment
        directory or its ``checkpoints`` directory; None if there is none."""
        d = Path(expr_or_ckpt_dir)
        if (d / "checkpoints").is_dir():
            d = d / "checkpoints"
        cands = [p for p in d.glob("step_*") if p.is_dir()
                 and re.fullmatch(r"step_\d+", p.name)]  # not a save in progress

        def step_of(p: Path) -> int:
            m = re.match(r"step_(\d+)", p.name)
            return int(m.group(1)) if m else -1

        return max(cands, key=step_of) if cands else None

    @staticmethod
    def load_payload(ckpt_path: tp.Union[str, Path]) -> dict:
        """A checkpoint's ``payload.pkl`` ({} if it has none), of either package
        (``load_pickle``). Unpickling runs code: read only checkpoints this
        project's trainers wrote."""
        f = Path(ckpt_path) / "payload.pkl"
        return load_pickle(f.read_bytes()) if f.exists() else {}

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

    # -- warmstart / finetune ---------------------------------------------------

    @staticmethod
    def filter_state_by_prefix(state: tp.Mapping, include: tp.Sequence[str] = (),
                               exclude: tp.Sequence[str] = ()) -> dict:
        """The tree with each leaf kept or set to None: a leaf is kept when
        ``include`` is empty or one of its entries starts or occurs in the leaf's
        ``/``-joined path, unless an entry of ``exclude`` does."""

        def hit(path: str, entries) -> bool:
            return any(path.startswith(p) or p in path for p in entries)

        def walk(node, path=""):
            if isinstance(node, tp.Mapping):
                return {k: walk(v, f"{path}/{k}" if path else str(k)) for k, v in node.items()}
            keep = (not include or hit(path, include)) and not (exclude and hit(path, exclude))
            return node if keep else None

        return walk(state)

    @staticmethod
    def merge_states(target: tp.Mapping, source: tp.Mapping) -> dict:
        """``target`` with each leaf that ``source`` holds (not None) and of the
        same shape replaced by the source's; a leaf of another shape keeps the
        target's."""

        def merge(t, s):
            if isinstance(t, tp.Mapping) and isinstance(s, tp.Mapping):
                return {k: merge(v, s[k]) if k in s else v for k, v in t.items()}
            if s is None:
                return t
            if hasattr(t, "shape") and hasattr(s, "shape") and tuple(t.shape) != tuple(s.shape):
                return t
            return s

        return merge(target, source)
