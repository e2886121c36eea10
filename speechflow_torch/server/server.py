"""DataServer: the broker of the data plane (counterpart of
``speechflow_tpu/server/server.py``), on the standard library.

A worker process that listens on two addresses: loaders (and clients) on the
front, batch workers on the back. It answers ``info`` with the pipeline's info
(and the number of workers), turns a loader's ``get_batch`` into a task of
samples drawn by the subset's sampler, hands tasks to idle workers, and routes
each result's frames back to the loader that asked, tagged with the loader's
request id (the loader reorders by it). Messages:

- ``info``, ``status`` (queued tasks, in flight, workers);
- ``get_batch`` (subset, batch size, request id, loader uid, optional
  ``shard``), answered by ``batch``, or ``reject`` when the tasks queued and in
  flight reach ``inflight_factor`` x workers (the loader retries the same
  request), or ``batch_failed`` when the worker raised or died;
- ``abort``: drop the loader's queued tasks.

Samplers: one shared per subset, so loaders draw disjoint samples, or one copy
per loader with ``synchronize_loaders`` (identical streams). A loader of a
data-parallel rank asks with ``shard=(rank, world)``: for each request id the
server draws the global batch of ``batch_size x world`` once, in request
order, and one worker collates all of it and cuts the rows into ``world``
parts, contiguous in draw order; rank r gets part r. So the ranks' parts of a
step are disjoint, together they are the batch one process would have drawn,
and each is padded as that one batch is (a model whose output depends on how
far a batch is padded sees what one process would).
"""

from __future__ import annotations

import collections
import copy
import itertools
import logging
import pickle
import threading
import time
import typing as tp
from multiprocessing.connection import Connection, wait

from speechflow_torch.concurrency.process_worker import ProcessWorker
from speechflow_torch.server import transport as T

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["DataServer", "sample_key"]

STATUS_EVERY_S = 600.0  # a status line in the log this often


def sample_key(sample) -> str:
    """A sample's name in the data plane's records: its file, else its label,
    else its index."""
    for attr in ("file_path", "label"):
        v = getattr(sample, attr, None)
        if v:
            return str(v)
    return str(getattr(sample, "index", id(sample)))


class _Acceptor:
    """Accepts authenticated connections of a listener in a thread."""

    def __init__(self, listener, role: str, sink: list, lock: threading.Lock):
        self.listener = listener
        self._thread = threading.Thread(target=self._loop, args=(role, sink, lock),
                                        daemon=True)
        self._thread.start()

    def _loop(self, role: str, sink: list, lock: threading.Lock) -> None:
        while True:
            try:
                conn = self.listener.accept()
            except OSError:  # closed: the server is stopping
                return
            except Exception as e:  # a client without the key
                LOGGER.warning("data server: refused a %s connection: %r", role, e)
                continue
            with lock:
                sink.append((role, conn))

    def close(self) -> None:
        try:
            self.listener.close()
        except OSError:
            pass


class DataServer(ProcessWorker):
    def __init__(self, frontend_addr: str, backend_addr: str, pipeline_payload: bytes,
                 authkey: bytes, inflight_factor: int = 4, n_workers_hint: int = 2,
                 synchronize_loaders: bool = False):
        super().__init__(none_stop=True, name="DataServer")
        self.frontend_addr = frontend_addr
        self.backend_addr = backend_addr
        self.pipeline_payload = pipeline_payload
        self.authkey = authkey
        self.inflight_factor = inflight_factor
        self.n_workers_hint = n_workers_hint
        self.synchronize_loaders = synchronize_loaders

    # -- child-side state -------------------------------------------------------

    def on_start(self) -> None:
        payload = pickle.loads(self.pipeline_payload)
        self.pipeline_payload = b""
        self.info = payload["info"]
        self.base_samplers = payload["samplers"]
        self.info_blob = pickle.dumps(self.info, protocol=5)
        self._new: list = []
        self._lock = threading.Lock()
        self._acceptors = [
            _Acceptor(T.listen(self.frontend_addr, self.authkey), "front", self._new,
                      self._lock),
            _Acceptor(T.listen(self.backend_addr, self.authkey), "back", self._new,
                      self._lock)]
        self.roles: tp.Dict[Connection, str] = {}
        self.tasks: collections.deque = collections.deque()
        self.idle_workers: collections.deque = collections.deque()
        self.busy: tp.Dict[Connection, int] = {}    # worker -> its task
        self.inflight: tp.Dict[int, dict] = {}      # task -> loader, subset, req, uid
        self.samplers: tp.Dict[tp.Tuple[str, str], tp.Any] = {}
        self.draws: tp.Dict[tp.Tuple[str, int], tuple] = {}   # global draws not yet queued
        self.next_draw: tp.Dict[str, int] = {}
        self.shards: tp.Dict[tp.Tuple[str, int], dict] = {}   # a global batch's parts
        self._ids = itertools.count()
        self.batches_done = 0
        self._last_status = time.time()

    @property
    def n_workers(self) -> int:
        return max(sum(r == "back" for r in self.roles.values()), self.n_workers_hint)

    def _sampler_for(self, subset: str, loader_uid: str):
        key = (subset, loader_uid if self.synchronize_loaders else "__shared__")
        if key not in self.samplers:
            base = self.base_samplers[subset]
            self.samplers[key] = base if key[1] == "__shared__" else copy.deepcopy(base)
        return self.samplers[key]

    def _global_draw(self, subset: str, req: int, size: int) -> tp.Tuple[list, bool]:
        """The global batch of request ``req``: the shared sampler draws them in
        request order, whatever order the ranks ask in."""
        sampler = self._sampler_for(subset, "")
        while self.next_draw.get(subset, 0) <= req:
            k = self.next_draw.get(subset, 0)
            self.draws[(subset, k)] = sampler.sampling(size)
            self.next_draw[subset] = k + 1
        return self.draws.pop((subset, req))

    # -- the loop ---------------------------------------------------------------

    def do_work_once(self) -> None:
        with self._lock:
            new, self._new[:] = list(self._new), []
        for role, conn in new:
            self.roles[conn] = role
        for conn in wait(list(self.roles), timeout=0.1):
            try:
                header, frames = T.recv(conn)
            except (EOFError, OSError):
                self._drop(conn)
                continue
            if self.roles[conn] == "front":
                self._on_frontend(conn, header)
            else:
                self._on_backend(conn, header, frames)
        self._dispatch()
        self._status_info()

    def _reply(self, conn: Connection, header: dict, frames: tp.Sequence = ()) -> None:
        try:
            T.send(conn, header, frames)
        except (OSError, EOFError):
            self._drop(conn)

    def _drop(self, conn: Connection) -> None:
        """A connection that closed: a loader's queued tasks go, a worker's task fails."""
        role = self.roles.pop(conn, None)
        if role == "front":
            self._abort(conn)
            for entry in self.shards.values():
                for rank, (c, _) in list(entry["waiting"].items()):
                    if c is conn:
                        del entry["waiting"][rank]
                        entry["sent"] += 1
            for meta in self.inflight.values():  # its tasks on workers end unrouted
                if meta["loader"] is conn:
                    meta["loader"] = None
        elif role == "back":
            if conn in self.idle_workers:
                self.idle_workers.remove(conn)
            tid = self.busy.pop(conn, None)
            if tid is not None:
                self._fail(tid, "the worker died")
        try:
            conn.close()
        except OSError:
            pass

    def _abort(self, conn: Connection) -> None:
        """Drop the queued tasks of the loader on ``conn``."""
        kept = collections.deque()
        for t in self.tasks:
            if self.inflight[t["task_id"]]["loader"] is conn:
                self.inflight.pop(t["task_id"])
            else:
                kept.append(t)
        self.tasks = kept

    def _fail(self, task_id: int, why: str) -> None:
        meta = self.inflight.pop(task_id, None)
        LOGGER.warning("data server: task %s failed: %s", task_id, why)
        if meta is not None and "shard" in meta:
            self.shards[meta["shard"]]["parts"] = "failed"
            self._send_parts(meta["shard"])
        elif meta is not None and meta["loader"] is not None:
            self._reply(meta["loader"], {"type": "batch_failed", "subset": meta["subset"],
                                         "req": meta["req"], "uid": meta["uid"]})

    def _status(self) -> dict:
        return {"type": "status", "tasks_queued": len(self.tasks),
                "inflight": len(self.inflight), "workers": self.n_workers,
                "batches_done": self.batches_done}

    def _status_info(self) -> None:
        now = time.time()
        if now - self._last_status >= STATUS_EVERY_S:
            self._last_status = now
            LOGGER.info("data server status: %s", self._status())

    def _on_frontend(self, conn: Connection, msg: dict) -> None:
        mtype = msg.get("type")
        if mtype == "info":
            self._reply(conn, {"type": "info", "n_workers": self.n_workers}, [self.info_blob])
        elif mtype == "status":
            self._reply(conn, self._status())
        elif mtype == "abort":
            self._abort(conn)
        elif mtype == "get_batch":
            reply = {"req": msg.get("req"), "uid": msg.get("uid", ""),
                     "subset": msg.get("subset", "")}
            if msg.get("shard") is not None:
                self._shard_request(conn, msg, reply)
                return
            if self._full():
                self._reply(conn, dict(reply, type="reject"))
                return
            samples, is_last = self._sampler_for(msg["subset"], msg.get("uid", "")).sampling(
                int(msg["batch_size"]))
            if not samples:
                self._reply(conn, dict(reply, type="batch_failed"))
                return
            self._queue(msg["subset"], samples, is_last, dict(reply, loader=conn))

    def _full(self) -> bool:
        return len(self.tasks) + len(self.inflight) >= self.inflight_factor * self.n_workers

    def _queue(self, subset: str, samples: list, is_last: bool, meta: dict,
               split: int = 0) -> None:
        task_id = next(self._ids)
        self.inflight[task_id] = meta
        self.tasks.append({"type": "task", "task_id": task_id, "subset": subset,
                           "is_last": is_last, "split": split,
                           "frames": T.dump_frames(list(samples))})

    def _shard_request(self, conn: Connection, msg: dict, reply: dict) -> None:
        """Rank r's part of a global batch: queued as one task by the first rank
        that asks for it, sent when the worker's parts are back."""
        rank, world = msg["shard"]
        key = (msg["subset"], msg["req"])
        entry = self.shards.get(key)
        if entry is None:
            if self._full():
                self._reply(conn, dict(reply, type="reject"))
                return
            samples, is_last = self._global_draw(msg["subset"], msg["req"],
                                                 int(msg["batch_size"]) * world)
            entry = self.shards[key] = {"world": world, "waiting": {}, "parts": None,
                                        "sent": 0}
            if not samples:
                entry["parts"] = "failed"
            else:
                self._queue(msg["subset"], samples, is_last, dict(reply, loader=None,
                                                                   shard=key), split=world)
        entry["waiting"][rank] = (conn, reply)
        self._send_parts(key)

    def _send_parts(self, key: tuple) -> None:
        entry = self.shards[key]
        if entry["parts"] is None:
            return
        for rank, (conn, reply) in list(entry["waiting"].items()):
            del entry["waiting"][rank]
            entry["sent"] += 1
            if entry["parts"] == "failed":
                self._reply(conn, dict(reply, type="batch_failed"))
            else:
                head, frames = entry["parts"][rank]
                self._reply(conn, dict(reply, type="batch", **head), frames)
        if entry["sent"] == entry["world"]:
            del self.shards[key]

    def _on_backend(self, conn: Connection, msg: dict, frames: tp.Sequence[bytes]) -> None:
        mtype = msg.get("type")
        if mtype == "info":
            self._reply(conn, {"type": "info"}, [self.info_blob])
        elif mtype == "ready":
            self.busy.pop(conn, None)
            if conn not in self.idle_workers:
                self.idle_workers.append(conn)
        elif mtype == "result":
            self.busy.pop(conn, None)
            meta = self.inflight.pop(msg["task_id"], None)
            self.batches_done += 1
            if meta is not None and "shard" in meta:
                parts, at = [], 0
                for part in msg["parts"]:  # each rank's keys and its frames, in rank order
                    parts.append(({"keys": part["keys"], "is_last": msg["is_last"]},
                                  frames[at:at + part["n"]]))
                    at += part["n"]
                self.shards[meta["shard"]]["parts"] = parts
                self._send_parts(meta["shard"])
            elif meta is not None and meta["loader"] is not None:
                # the batch's frames go on as they came: the broker never unpickles them
                self._reply(meta["loader"], {"type": "batch", "subset": meta["subset"],
                                             "req": meta["req"], "uid": meta["uid"],
                                             "keys": msg["keys"], "is_last": msg["is_last"]},
                            frames)
        elif mtype == "error":
            self.busy.pop(conn, None)
            self._fail(msg["task_id"], msg.get("error", ""))

    def _dispatch(self) -> None:
        while self.tasks and self.idle_workers:
            task = self.tasks.popleft()
            worker = self.idle_workers.popleft()
            frames = task.pop("frames")
            self.busy[worker] = task["task_id"]
            try:
                T.send(worker, task, frames)
            except (OSError, EOFError):
                self._drop(worker)

    def on_finish(self) -> None:
        for acc in self._acceptors:
            acc.close()
        for conn in list(self.roles):
            try:
                conn.close()
            except OSError:
                pass
        T.unlink_addr(self.frontend_addr)
        T.unlink_addr(self.backend_addr)
