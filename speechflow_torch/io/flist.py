"""File lists of a corpus (counterpart of ``speechflow_tpu/io/flist.py``, the
two functions the training pipeline uses)."""

from __future__ import annotations

import random
import typing as tp
from pathlib import Path

__all__ = ["construct_file_list", "split_file_list"]


def construct_file_list(data_root: tp.Union[str, Path], ext: str = ".wav",
                        with_subfolders: bool = True) -> tp.List[str]:
    """Sorted paths of the files with ``ext`` under ``data_root``."""
    pattern = f"**/*{ext}" if with_subfolders else f"*{ext}"
    return sorted(str(p) for p in Path(data_root).glob(pattern))


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
