"""BatchWorker / WorkerPool: the data plane's processing (counterpart of
``speechflow_tpu/server/worker.py``).

Each worker is a process of its own. It asks the server for the pipeline's info,
rebuilds its handler chain and collate (``DataPipeline.from_info``, without
the datasets), announces ``ready``, and then for each task runs the handlers
over a writable copy of each sample (through the feature cache where the
config has one; a failing sample is dropped, as in training), collates what is
left and sends the batch back with the kept samples' keys; a task of a global
batch (``split``) comes back as the ranks' parts of the collated batch (its
rows, padded as the whole batch is), each with its keys. It announces
``ready`` again only after its result is sent, so the server never writes to a
worker that is writing to it.
"""

from __future__ import annotations

import dataclasses
import logging
import pickle
import typing as tp

import numpy as np

from speechflow_torch.concurrency.process_worker import ProcessWorker, stop_all
from speechflow_torch.server import transport as T
from speechflow_torch.server.server import sample_key

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["BatchWorker", "WorkerPool", "take_rows"]


def take_rows(tree: tp.Any, rows: tp.Sequence[int], n: int) -> tp.Any:
    """The rows ``rows`` of a collated batch of ``n``: every array, list or tuple
    of ``n`` along its first axis, in dataclasses and dicts."""
    if isinstance(tree, np.ndarray):
        return tree[list(rows)] if tree.ndim and tree.shape[0] == n else tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: take_rows(getattr(tree, f.name), rows, n)
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: take_rows(v, rows, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and len(tree) == n:
        return type(tree)(tree[i] for i in rows)
    return tree


class BatchWorker(ProcessWorker):
    def __init__(self, backend_addr: str, authkey: bytes, worker_idx: int = 0):
        super().__init__(none_stop=True, name=f"BatchWorker-{worker_idx}")
        self.backend_addr = backend_addr
        self.authkey = authkey
        self.worker_idx = worker_idx

    def on_start(self) -> None:
        from speechflow_torch.data.core.components import DataPipeline

        self.conn = T.connect(self.backend_addr, self.authkey)
        T.send(self.conn, {"type": "info"})
        _, frames = T.recv(self.conn)
        pipeline = DataPipeline.from_info(pickle.loads(frames[0]))
        self.process = pipeline.process
        T.send(self.conn, {"type": "ready"})

    def do_work_once(self) -> None:
        if not self.conn.poll(0.2):
            return
        try:
            msg, frames = T.recv(self.conn)
        except (EOFError, OSError):  # the server is gone
            self.request_stop()
            return
        if msg.get("type") != "task":
            return
        try:
            header, out = self._result(msg, T.load_frames(frames, writable=True))
        except Exception as e:
            LOGGER.warning("worker %d failed a task: %r", self.worker_idx, e)
            header, out = {"type": "error", "task_id": msg["task_id"], "error": repr(e)}, []
        try:
            T.send(self.conn, header, out)
            T.send(self.conn, {"type": "ready"})
        except (EOFError, OSError):  # the server is gone: nobody wants the batch
            self.request_stop()

    def _result(self, msg: dict, samples: list) -> tp.Tuple[dict, list]:
        """The task's header and frames: the collated batch, or, for a global batch
        (``split``), its rows cut into the ranks' parts."""
        done = [self.process.sample(s) for s in samples]
        kept = [d for d in done if d is not None]
        batch = self.process.collate_fn(kept) if kept else None
        head = {"type": "result", "task_id": msg["task_id"], "is_last": msg["is_last"]}
        if not msg.get("split"):
            return dict(head, keys=[sample_key(s) for s in kept]), T.dump_frames(batch)
        parts, out = [], []
        row = {i: j for j, i in enumerate(i for i, d in enumerate(done) if d is not None)}
        per = -(-len(samples) // msg["split"])
        for r in range(msg["split"]):
            rows = [row[i] for i in range(r * per, min((r + 1) * per, len(samples)))
                    if i in row]
            f = T.dump_frames(take_rows(batch, rows, len(kept)) if rows else None)
            parts.append({"keys": [sample_key(kept[j]) for j in rows], "n": len(f)})
            out += f
        return dict(head, parts=parts), out

    def on_finish(self) -> None:
        conn = getattr(self, "conn", None)
        if conn is not None:
            conn.close()


class WorkerPool:
    def __init__(self, backend_addr: str, authkey: bytes, n_workers: int = 2):
        self.workers = [BatchWorker(backend_addr, authkey, i) for i in range(n_workers)]

    def start(self, timeout: float = 300.0) -> "WorkerPool":
        """Start every worker and wait for each to have the pipeline."""
        try:
            for w in self.workers:
                w.launch()
            for w in self.workers:
                w.wait_started(timeout)
        except BaseException:
            self.stop()
            raise
        return self

    def stop(self, timeout: float = 10.0) -> None:
        stop_all(self.workers, timeout)

    def __len__(self) -> int:
        return len(self.workers)
