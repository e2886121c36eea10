"""File lists of a corpus (counterpart of ``speechflow_tpu/io/flist.py``):
files by extension, a seeded train/test split, and plain-text manifests."""

from __future__ import annotations

import random
import typing as tp
from pathlib import Path

__all__ = ["generate_file_list", "read_file_list", "construct_file_list", "split_file_list"]


def construct_file_list(data_root: tp.Union[str, Path], ext: str = ".wav",
                        with_subfolders: bool = True,
                        path_filter: tp.Optional[tp.Callable[[Path], bool]] = None
                        ) -> tp.List[str]:
    """Sorted paths of the files with ``ext`` under ``data_root`` (those
    ``path_filter`` accepts, where given)."""
    pattern = f"**/*{ext}" if with_subfolders else f"*{ext}"
    return sorted(str(p) for p in Path(data_root).glob(pattern)
                  if path_filter is None or path_filter(p))


def split_file_list(files: tp.Sequence[str], split_ratio: float = 0.9, seed: int = 0,
                    min_test: int = 1) -> tp.Tuple[tp.List[str], tp.List[str]]:
    """(train, test), each sorted: a seeded shuffle cut at ``split_ratio``,
    leaving at least ``min_test`` files to test."""
    files = list(files)
    random.Random(seed).shuffle(files)
    n_train = int(len(files) * split_ratio)
    n_train = min(n_train, len(files) - min_test) if len(files) > min_test \
        else max(0, len(files) - 1)
    return sorted(files[:n_train]), sorted(files[n_train:])


def generate_file_list(data_root: tp.Union[str, Path], ext: str = ".wav",
                       split_ratio: float = 0.9, seed: int = 0) -> tp.Dict[str, tp.List[str]]:
    """``{"train": [...], "test": [...]}`` of the files with ``ext`` under ``data_root``."""
    train, test = split_file_list(construct_file_list(data_root, ext=ext),
                                  split_ratio=split_ratio, seed=seed)
    return {"train": train, "test": test}


def read_file_list(path: tp.Union[str, Path],
                   data_root: tp.Optional[tp.Union[str, Path]] = None,
                   max_num_samples: tp.Optional[int] = None) -> tp.List[str]:
    """A manifest's paths: one a line, blank lines and ``#`` comments skipped,
    each under ``data_root`` where given, at most ``max_num_samples``."""
    lines = [ln.strip() for ln in Path(path).read_text(encoding="utf-8").splitlines()]
    lines = [ln for ln in lines if ln and not ln.startswith("#")]
    if data_root is not None:
        lines = [str(Path(data_root) / ln) for ln in lines]
    return lines[:max_num_samples] if max_num_samples else lines
