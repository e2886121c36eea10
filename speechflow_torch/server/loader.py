"""DataLoader: a loader's side of the data plane (counterpart of
``speechflow_tpu/server/loader.py``).

A thread keeps requests outstanding against the server (``min_prefetch`` from
``start``, ``prefetch_factor`` once batches are read: a loader never read, a
validation subset before its first validation, takes little of the workers'
time), retries a rejected request under the same id, and releases batches in
request order (workers finish out of order), so an epoch's end is seen where
the sampler drew it. ``next_batch(timeout)`` returns the next collated batch,
as ``AudioLoader.next_batch`` does (``next_item`` the ``Batch`` record with the
samples' keys and ``is_last``); ``drop_non_full`` and ``min_batch_size`` filter
batches, and a server silent for ``dead_after_s`` while batches are awaited is
logged. Arrays of a batch are read-only views of the received frames: copy
before writing. ``wait_s`` sums the time ``next_batch`` waited. A loader of a
data-parallel rank passes ``shard=(rank, world)`` and ``batch_size`` its share.
"""

from __future__ import annotations

import dataclasses
import logging
import pickle
import threading
import time
import typing as tp
import uuid
from collections import deque

from speechflow_torch.server import transport as T

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["DataLoader", "Batch"]


@dataclasses.dataclass
class Batch:
    collated: tp.Any           # the collate's output (numpy)
    keys: tp.List[str]         # the kept samples' keys (``server.sample_key``)
    is_last: bool              # the sampler's epoch ended with this batch

    @property
    def size(self) -> int:
        return len(self.keys)


class DataLoader:
    def __init__(self, server_addr: str, subset: str, batch_size: int, authkey: bytes,
                 prefetch_factor: int = 8, min_prefetch: int = 2, drop_non_full: bool = False,
                 min_batch_size: int = 1, dead_after_s: float = 100.0,
                 shard: tp.Optional[tp.Tuple[int, int]] = None):
        self.server_addr = server_addr
        self.subset = subset
        self.batch_size = batch_size
        self.authkey = authkey
        self.prefetch_factor = prefetch_factor
        self.min_prefetch = min(min_prefetch, prefetch_factor)
        self.drop_non_full = drop_non_full
        self.min_batch_size = min_batch_size
        self.dead_after_s = dead_after_s
        self.shard = tuple(shard) if shard is not None else None
        self.uid = uuid.uuid4().hex
        self.info: dict = {}
        self.n_workers = 0
        self.batches_received = 0
        self.wire_bytes_total = 0
        self.wait_s = 0.0
        self.last_keys: tp.List[str] = []
        self._queue: deque = deque()
        self._outstanding: set = set()
        self._reorder: tp.Dict[int, tp.Optional[Batch]] = {}
        self._req_counter = 0
        self._next_seq = 0
        self._consuming = False
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread: tp.Optional[threading.Thread] = None
        self._conn = None

    # -- lifecycle ----------------------------------------------------------------

    def start(self, timeout: float = 60.0) -> "DataLoader":
        """Connect, read the server's info, start the request thread."""
        self._conn = T.connect(self.server_addr, self.authkey)
        T.send(self._conn, {"type": "info"})
        if not self._conn.poll(timeout):
            self._conn.close()
            raise TimeoutError(f"data server at {self.server_addr} did not answer info")
        header, frames = T.recv(self._conn)
        self.info = pickle.loads(frames[0])
        self.n_workers = header.get("n_workers", 1)
        self._last_recv = time.time()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"DataLoader-{self.subset}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(3)
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass

    close = stop

    # -- the request thread ---------------------------------------------------------

    def _send_request(self, req: int) -> None:
        msg = {"type": "get_batch", "subset": self.subset, "batch_size": self.batch_size,
               "uid": self.uid, "req": req}
        if self.shard is not None:
            msg["shard"] = self.shard
        T.send(self._conn, msg)

    def _request_more(self) -> None:
        target = self.prefetch_factor if self._consuming else self.min_prefetch
        with self._cond:
            held = len(self._queue) + len(self._reorder)
        while len(self._outstanding) + held < target:
            req = self._req_counter
            self._req_counter += 1
            self._outstanding.add(req)
            self._send_request(req)

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                self._request_more()
                if not self._conn.poll(0.1):
                    if (time.time() - self._last_recv > self.dead_after_s
                            and self._outstanding and self._consuming):
                        LOGGER.warning("loader %s: the data server was silent for %.0f s",
                                       self.uid[:6], self.dead_after_s)
                        self._last_recv = time.time()
                    continue
                header, frames = T.recv(self._conn)
                self._last_recv = time.time()
                mtype, req = header.get("type"), header.get("req")
                if mtype == "batch":
                    self._outstanding.discard(req)
                    self.batches_received += 1
                    self.wire_bytes_total += sum(len(f) for f in frames)
                    self._release(req, Batch(T.load_frames(frames), list(header["keys"]),
                                             bool(header["is_last"])))
                elif mtype == "batch_failed":
                    self._outstanding.discard(req)
                    self._release(req, None)
                elif mtype == "reject":  # backpressure: the same id again, later
                    time.sleep(0.05)
                    if req in self._outstanding:
                        self._send_request(req)
        except (EOFError, OSError) as e:
            if not self._stop.is_set():
                LOGGER.warning("loader %s: connection lost: %r", self.uid[:6], e)

    def _release(self, req: int, batch: tp.Optional[Batch]) -> None:
        with self._cond:
            self._reorder[req] = batch
            while self._next_seq in self._reorder:
                b = self._reorder.pop(self._next_seq)
                self._next_seq += 1
                if b is not None:
                    self._queue.append(b)
            self._cond.notify_all()

    # -- consumption ------------------------------------------------------------------

    def _keep(self, batch: Batch) -> bool:
        if batch.size < self.min_batch_size:
            return False
        return not (self.drop_non_full and batch.size < self.batch_size and not batch.is_last)

    def next_item(self, timeout: float = 120.0) -> Batch:
        """The next ``Batch``; ``TimeoutError`` after ``timeout`` seconds."""
        t0 = time.perf_counter()
        deadline = time.time() + timeout
        try:
            with self._cond:
                self._consuming = True
                while True:
                    while self._queue:
                        batch = self._queue.popleft()
                        if self._keep(batch):
                            self.last_keys = batch.keys
                            return batch
                    if not self._thread.is_alive():
                        raise RuntimeError(f"loader {self.uid[:6]}: the request thread ended")
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        raise TimeoutError(f"no batch within {timeout}s (subset={self.subset})")
                    self._cond.wait(min(remaining, 0.5))
        finally:
            self.wait_s += time.perf_counter() - t0

    def next_batch(self, timeout: float = 120.0) -> tp.Any:
        """The next collated batch."""
        return self.next_item(timeout).collated

    def __iter__(self):
        """One epoch of ``Batch`` records: until ``is_last``."""
        while True:
            batch = self.next_item()
            yield batch
            if batch.is_last:
                return

    def epochs(self, n: int):
        for _ in range(n):
            yield iter(self)

    def test_connection(self, duration_s: float = 10.0) -> dict:
        """Batches and samples a second over ``duration_s``, and MB a batch on
        the wire (counted by the request thread)."""
        bytes0, n_batches, n_samples = self.wire_bytes_total, 0, 0
        t0 = time.time()
        while time.time() - t0 < duration_s:
            batch = self.next_item(timeout=max(duration_s, 30.0))
            n_batches += 1
            n_samples += batch.size
        elapsed = max(time.time() - t0, 1e-6)
        wire = self.wire_bytes_total - bytes0
        return {"batches_per_s": n_batches / elapsed, "samples_per_s": n_samples / elapsed,
                "mb_per_batch": wire / max(n_batches, 1) / 1e6, "n_batches": n_batches}

    def device_iterator(self, device, n_batches: tp.Optional[int] = None,
                        put_fn: tp.Optional[tp.Callable] = None):
        """``(Batch, collated on device)`` pairs, one batch moved ahead of the one
        yielded; ``put_fn(collated)`` defaults to every numpy array as a tensor
        on ``device``. Ends after ``n_batches``, or at the epoch's end when None."""
        import torch

        from speechflow_torch.training.trainer import _place

        dev = torch.device(device)
        put_fn = put_fn or (lambda collated: _place(collated, dev))
        pending, count = None, 0
        while n_batches is None or count < n_batches:
            batch = self.next_item()
            moved = put_fn(batch.collated)
            if pending is not None:
                yield pending
                count += 1
            pending = (batch, moved)
            if batch.is_last and n_batches is None:
                break
        if pending is not None and (n_batches is None or count < n_batches):
            yield pending
