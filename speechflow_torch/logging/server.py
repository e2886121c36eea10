"""One log file for every process of an experiment (counterpart of
``speechflow_tpu/logging/server.py``, which sends records over ZMQ).

``LoggingServer`` listens on a local TCP port in a thread and writes the
records that ``logging.handlers.SocketHandler`` sends it (the standard
library's length-prefixed pickles) to the experiment's log file, and keeps
profiler events (``profiler_event``: a tag and seconds) for a mean / std
summary at the end of the file (as JAX's server, not as lines of their own).
Inside ``with LoggingServer(...)`` this process's root logger sends there, and
the address is in ``SPEECHFLOW_LOG_ADDR``, which spawned children inherit:
``attach_from_env`` (called by every ``ProcessWorker`` and by a training rank)
attaches their handler, so the data server's workers and the other ranks log to
the same file.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import pickle
import socketserver
import struct
import threading
import time
import typing as tp
from pathlib import Path

__all__ = ["LoggingServer", "attach_socket_handler", "attach_from_env", "profiler_event",
           "profiler_record", "LOG_ADDR_ENV"]

LOG_ADDR_ENV = "SPEECHFLOW_LOG_ADDR"
FORMAT = "%(asctime)s %(levelname)s %(processName)s[%(process)d] %(name)s: %(message)s"
_ATTACHED: tp.Dict[str, logging.Handler] = {}


def attach_socket_handler(address: str, level: int = logging.INFO) -> logging.Handler:
    """Send this process's root-logger records at ``level`` and above to the
    ``LoggingServer`` at ``address`` (``host:port``); once per address."""
    if address in _ATTACHED:
        return _ATTACHED[address]
    host, port = address.rsplit(":", 1)
    handler = logging.handlers.SocketHandler(host, int(port))
    handler.setLevel(level)
    root = logging.getLogger()
    root.addHandler(handler)
    if root.level > level or root.level == logging.NOTSET:
        root.setLevel(level)
    _ATTACHED[address] = handler
    return handler


def attach_from_env() -> tp.Optional[logging.Handler]:
    """``attach_socket_handler`` to the address in ``SPEECHFLOW_LOG_ADDR``, if any."""
    address = os.environ.get(LOG_ADDR_ENV)
    return attach_socket_handler(address) if address else None


def profiler_event(tag: str, seconds: float, logger: str = "speechflow_torch") -> None:
    """A timing the ``LoggingServer`` sums up by ``tag`` (mean and std) at its end."""
    lg = logging.getLogger(logger)
    if lg.isEnabledFor(logging.INFO):
        lg.handle(profiler_record(tag, seconds, logger))


def profiler_record(tag: str, seconds: float, logger: str = "speechflow_torch"
                    ) -> logging.LogRecord:
    """``profiler_event``'s record, for a handler to take directly (``utils.profiler``
    sends it to the server alone, not to the console)."""
    return logging.getLogger(logger).makeRecord(
        logger, logging.INFO, __file__, 0, "profiler %s %.6f s", (tag, float(seconds)), None,
        extra={"sf_profiler": (tag, float(seconds))})


class _Receiver(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        owner: "LoggingServer" = self.server.owner  # type: ignore[attr-defined]
        with owner._lock:
            owner._open += 1
        try:
            while True:
                head = self.connection.recv(4)
                if len(head) < 4:
                    return
                n = struct.unpack(">L", head)[0]
                chunk = b""
                while len(chunk) < n:
                    part = self.connection.recv(n - len(chunk))
                    if not part:
                        return
                    chunk += part
                owner._write(logging.makeLogRecord(pickle.loads(chunk)))
        finally:
            with owner._lock:
                owner._open -= 1


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class LoggingServer:
    """Writes every process's records to ``log_file``; a context manager."""

    def __init__(self, log_file: tp.Union[str, Path], host: str = "127.0.0.1", port: int = 0,
                 address: tp.Optional[str] = None):
        """Listens on ``host:port`` (port 0: a free one), or on ``address``
        (``"host:port"`` or ``"tcp://host:port"``, JAX's keyword)."""
        if address is not None:
            host, _, port_s = address.split("://")[-1].rpartition(":")
            port = int(port_s)
        self.log_file = Path(log_file)
        self.log_file.parent.mkdir(parents=True, exist_ok=True)
        self._server = _TCPServer((host, port), _Receiver, bind_and_activate=True)
        self._server.owner = self
        self.address = "%s:%d" % self._server.server_address[:2]
        self._lock = threading.Lock()
        self._open = 0
        self._file: tp.Optional[tp.TextIO] = None
        self._thread: tp.Optional[threading.Thread] = None
        self._formatter = logging.Formatter(FORMAT)
        self._saved_env: tp.Optional[str] = None
        self.profiler_events: tp.Dict[str, tp.List[float]] = {}
        self.pids: tp.Set[int] = set()
        self._drained = threading.Event()

    @staticmethod
    def ctx(experiment_path: tp.Union[str, Path]) -> "LoggingServer":
        return LoggingServer(Path(experiment_path) / "experiment.log")

    def _write(self, record: logging.LogRecord) -> None:
        with self._lock:
            if getattr(record, "sf_drain", None) == self.address:
                self._drained.set()
                return
            self.pids.add(record.process)
            event = getattr(record, "sf_profiler", None)
            if event is not None:  # summed up at the end, not a line of the log
                self.profiler_events.setdefault(event[0], []).append(event[1])
                return
            if self._file is not None:
                self._file.write(self._formatter.format(record) + "\n")
                self._file.flush()

    def __enter__(self) -> "LoggingServer":
        self._file = self.log_file.open("a")
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        kwargs={"poll_interval": 0.1}, daemon=True,
                                        name="LoggingServer")
        self._thread.start()
        self._saved_env = os.environ.get(LOG_ADDR_ENV)
        os.environ[LOG_ADDR_ENV] = self.address
        attach_socket_handler(self.address)
        return self

    def __exit__(self, *exc) -> None:
        from speechflow_torch.utils.profiler import flush_spans

        flush_spans()  # this process's model spans still waiting for the device
        handler = _ATTACHED.pop(self.address, None)
        if handler is not None:
            logging.getLogger().removeHandler(handler)
            if handler.sock is not None:  # this process's records, in order, then a mark
                handler.handle(logging.makeLogRecord({"sf_drain": self.address}))
                self._drained.wait(2.0)
            handler.close()
        if self._saved_env is None:
            os.environ.pop(LOG_ADDR_ENV, None)
        else:
            os.environ[LOG_ADDR_ENV] = self._saved_env
        deadline = time.time() + 2.0  # the open connections' last records
        while self._open and time.time() < deadline:
            time.sleep(0.02)
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(2)
        with self._lock:
            self._write_profiler_summary()
            self._file.close()
            self._file = None

    def _write_profiler_summary(self) -> None:
        if not self.profiler_events:
            return
        import statistics

        self._file.write("=== profiler summary ===\n")
        for tag, vals in sorted(self.profiler_events.items()):
            std = statistics.pstdev(vals) if len(vals) > 1 else 0.0
            self._file.write(f"{tag}: n={len(vals)} mean={statistics.fmean(vals) * 1e3:.2f}ms "
                             f"std={std * 1e3:.2f}ms\n")
