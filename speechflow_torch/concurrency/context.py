"""How the port starts its worker processes.

``worker_context()`` is ``forkserver``: one server process, started from a
fresh interpreter, imports torch and the data modules once (``PRELOAD``), and
each worker is a fork of it. A worker so starts in milliseconds, where a
``spawn``ed one imports torch anew (seconds), and no worker is a fork of a
process that has initialised CUDA (which fails or hangs). A fork of the server
inherits the server's environment, not its parent's, so the parent's
environment travels with each worker and ``adopt_environment`` applies it
first, as ``spawn`` would have.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import typing as tp

__all__ = ["PRELOAD", "worker_context", "adopt_environment"]

PRELOAD = ("numpy", "torch", "speechflow_torch.data.core.components",
           "speechflow_torch.server.worker")


def worker_context():
    """The multiprocessing context of the data workers, servers and proxies:
    ``forkserver`` with ``PRELOAD`` (``spawn`` where there is no forkserver)."""
    if "forkserver" not in mp.get_all_start_methods():
        return mp.get_context("spawn")
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(list(PRELOAD))
    return ctx


def adopt_environment(env: tp.Mapping[str, str], *_) -> None:
    """Make this process's environment ``env`` (its parent's at launch); the
    extra arguments let it serve as a DataLoader's ``worker_init_fn``."""
    for key in set(os.environ) - set(env):
        del os.environ[key]
    os.environ.update(env)
