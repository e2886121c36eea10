"""The data plane's wire: messages over ``multiprocessing.connection`` (an
authenticated Unix or TCP socket, no ZMQ).

A message is a pickled header dict followed by ``n_frames`` raw frames. A
batch or a sample list travels as pickle protocol 5 with its numpy buffers
out of band (``dump_frames``): the server routes a worker's frames to the
loader without unpickling them, a loader's arrays are read-only views of the
received frames, and a worker gets writable copies (its handlers may mutate
a sample in place). Addresses are ``ipc://<path>`` (a Unix socket) or
``tcp://host:port``.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import typing as tp
import uuid
from multiprocessing.connection import Client, Connection, Listener

__all__ = ["dump_frames", "load_frames", "send", "recv", "listen", "connect",
           "local_addr", "tcp_addr", "unlink_addr", "find_free_port"]

_UNIX_PATH_MAX = 100  # sun_path holds 108 bytes


def dump_frames(obj: tp.Any) -> tp.List[tp.Union[bytes, memoryview]]:
    """``obj`` as frames: the pickle, then each out-of-band buffer."""
    buffers: tp.List[pickle.PickleBuffer] = []
    head = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    return [head, *(b.raw() for b in buffers)]


def load_frames(frames: tp.Sequence[bytes], writable: bool = False) -> tp.Any:
    """The object of ``dump_frames``; its arrays are views of ``frames``
    (read-only) unless ``writable``, which copies them."""
    rest = [bytearray(f) for f in frames[1:]] if writable else list(frames[1:])
    return pickle.loads(frames[0], buffers=rest)


def send(conn: Connection, header: dict, frames: tp.Sequence = ()) -> None:
    conn.send_bytes(pickle.dumps(dict(header, n_frames=len(frames)), protocol=5))
    for f in frames:
        conn.send_bytes(f)


def recv(conn: Connection) -> tp.Tuple[dict, tp.List[bytes]]:
    header = pickle.loads(conn.recv_bytes())
    return header, [conn.recv_bytes() for _ in range(header.get("n_frames", 0))]


def _parse(addr: str):
    if addr.startswith("ipc://"):
        return addr[len("ipc://"):], "AF_UNIX"
    if addr.startswith("tcp://"):
        host, port = addr[len("tcp://"):].rsplit(":", 1)
        return (host, int(port)), "AF_INET"
    raise ValueError(f"address {addr!r}: ipc://<path> or tcp://host:port")


def listen(addr: str, authkey: bytes) -> Listener:
    address, family = _parse(addr)
    return Listener(address, family=family, authkey=authkey, backlog=64)


def connect(addr: str, authkey: bytes, timeout: float = 60.0) -> Connection:
    """A connection to the listener at ``addr``, retried for ``timeout``
    seconds while nothing listens there yet."""
    import time

    address, family = _parse(addr)
    deadline = time.time() + timeout
    while True:
        try:
            return Client(address, family=family, authkey=authkey)
        except (FileNotFoundError, ConnectionRefusedError):
            if time.time() > deadline:
                raise
            time.sleep(0.05)


def find_free_port(host: str = "127.0.0.1") -> int:
    import socket

    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def tcp_addr(host: str = "127.0.0.1") -> str:
    return f"tcp://{host}:{find_free_port(host)}"


def local_addr(tag: str) -> str:
    """A fresh same-host address: a Unix socket in the temporary directory, or
    a TCP port on 127.0.0.1 where that path would be too long."""
    path = os.path.join(tempfile.gettempdir(), f"sftorch-{tag}-{uuid.uuid4().hex[:12]}.sock")
    if len(path.encode()) > _UNIX_PATH_MAX:
        return tcp_addr()
    return f"ipc://{path}"


def unlink_addr(addr: str) -> None:
    """Remove a Unix socket's file (a listener that was terminated leaves it)."""
    if addr.startswith("ipc://"):
        try:
            os.unlink(addr[len("ipc://"):])
        except OSError:
            pass
