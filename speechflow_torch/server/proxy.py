"""Proxy: one front for several data servers (counterpart of
``speechflow_tpu/server/proxy.py``).

Loaders speak to the proxy as to a server. Its ``info`` is the servers' infos
merged (``DataPipeline.aggregate_info``: the singletons' states, the dataset
sizes, the alphabet); a ``get_batch`` goes to the servers in turn, and each
reply goes back to the loader that asked (routed by loader uid, subset and
request id). ``batch_preprocessing(collated)`` may be overridden to change
batches on the way.
"""

from __future__ import annotations

import itertools
import logging
import pickle
import threading
import typing as tp
from multiprocessing.connection import Connection, wait

from speechflow_torch.concurrency.process_worker import ProcessWorker
from speechflow_torch.server import transport as T
from speechflow_torch.server.server import _Acceptor

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["Proxy"]


class Proxy(ProcessWorker):
    def __init__(self, frontend_addr: str, backend_addrs: tp.Sequence[str], authkey: bytes):
        super().__init__(none_stop=True, name="DataProxy")
        self.frontend_addr = frontend_addr
        self.backend_addrs = list(backend_addrs)
        self.authkey = authkey

    def batch_preprocessing(self, collated: tp.Any) -> tp.Any:
        """Override point: a batch on its way to the loader."""
        return collated

    def on_start(self) -> None:
        from speechflow_torch.data.core.components import DataPipeline

        self.backends: tp.List[Connection] = []
        infos = []
        for addr in self.backend_addrs:
            conn = T.connect(addr, self.authkey)
            T.send(conn, {"type": "info"})
            if not conn.poll(60):
                raise TimeoutError(f"data server at {addr} did not answer info")
            infos.append(pickle.loads(T.recv(conn)[1][0]))
            self.backends.append(conn)
        self.info_blob = pickle.dumps(DataPipeline.aggregate_info(infos), protocol=5)
        self._new: list = []
        self._lock = threading.Lock()
        self._acceptor = _Acceptor(T.listen(self.frontend_addr, self.authkey), "front",
                                   self._new, self._lock)
        self.loaders: tp.List[Connection] = []
        self._rr = itertools.cycle(range(len(self.backends)))
        self._route: tp.Dict[tuple, Connection] = {}
        self._hooked = type(self).batch_preprocessing is not Proxy.batch_preprocessing

    def do_work_once(self) -> None:
        with self._lock:
            new, self._new[:] = list(self._new), []
        self.loaders.extend(conn for _, conn in new)
        for conn in wait(self.loaders + self.backends, timeout=0.1):
            try:
                header, frames = T.recv(conn)
            except (EOFError, OSError):
                if conn in self.backends:
                    raise RuntimeError("a data server behind the proxy closed")
                self.loaders.remove(conn)
                continue
            if conn in self.backends:
                self._from_backend(header, frames)
            else:
                self._from_loader(conn, header)

    def _from_loader(self, conn: Connection, msg: dict) -> None:
        mtype = msg.get("type")
        if mtype == "info":
            T.send(conn, {"type": "info", "n_workers": len(self.backends)}, [self.info_blob])
        elif mtype == "status":
            T.send(conn, {"type": "status", "servers": len(self.backends),
                          "routed": len(self._route)})
        elif mtype == "get_batch":
            self._route[(msg.get("uid", ""), msg.get("subset", ""), msg.get("req"))] = conn
            T.send(self.backends[next(self._rr)], msg)
        elif mtype == "abort":
            for b in self.backends:
                T.send(b, msg)

    def _from_backend(self, msg: dict, frames: tp.List[bytes]) -> None:
        key = (msg.get("uid", ""), msg.get("subset", ""), msg.get("req"))
        conn = self._route.get(key)
        if conn is None or msg.get("type") not in ("batch", "batch_failed", "reject"):
            return
        if msg["type"] != "reject":
            del self._route[key]
        if msg["type"] == "batch" and self._hooked:
            frames = T.dump_frames(self.batch_preprocessing(T.load_frames(frames)))
        try:
            T.send(conn, msg, frames)
        except (EOFError, OSError):
            if conn in self.loaders:
                self.loaders.remove(conn)

    def on_finish(self) -> None:
        acceptor = getattr(self, "_acceptor", None)
        if acceptor is not None:
            acceptor.close()
        for conn in (*getattr(self, "loaders", ()), *getattr(self, "backends", ())):
            conn.close()
        T.unlink_addr(self.frontend_addr)
