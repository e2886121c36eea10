"""Logging helpers (counterpart of ``speechflow_tpu/logging/utils.py``)."""

from __future__ import annotations

import logging
import traceback
import typing as tp
from pathlib import Path

__all__ = ["LOGGER", "trace", "log_to_file"]

LOGGER = logging.getLogger("speechflow_torch")


def trace(owner: tp.Any, message: str = "", full: bool = True) -> str:
    """``[owner] message``, with the current exception's traceback when ``full``."""
    name = owner if isinstance(owner, str) else type(owner).__name__
    out = f"[{name}] {message}"
    if full:
        tb = traceback.format_exc()
        if tb and "NoneType: None" not in tb:
            out += "\n" + tb
    return out


def log_to_file(path: tp.Union[str, Path], level: int = logging.INFO) -> logging.Handler:
    """A file handler on the root logger."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    h = logging.FileHandler(path)
    h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    h.setLevel(level)
    logging.getLogger().addHandler(h)
    return h
