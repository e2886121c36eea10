"""A worker process with a lifecycle (counterpart of
``speechflow_tpu/concurrency/process_worker.py``).

Subclasses implement ``on_start`` / ``do_work_once`` / ``on_finish``; the
parent sees shared started and finished flags. ``none_stop`` keeps the loop
going after ``do_work_once`` raises instead of ending it. Children start from
``concurrency.context.worker_context()`` (forks of a forkserver that has
imported torch, never of a process that has initialised CUDA) with the
parent's environment at launch. A worker is not daemonic, so it may start children of its
own (a data server's workers); ``stop`` joins it, and terminates it after
``timeout``. A child inherits the parent's log address
(``speechflow_torch.logging``), so its records reach the experiment's log.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import time
import traceback
import typing as tp

from speechflow_torch.concurrency.context import adopt_environment, worker_context

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["ProcessWorker", "stop_all"]


def stop_all(workers: tp.Sequence["ProcessWorker"], timeout: float = 10.0) -> None:
    """Ask every worker's loop to end, then join them all within ``timeout`` seconds
    together; any still alive is terminated (killed if need be)."""
    for w in workers:
        w.request_stop()
    deadline = time.time() + timeout
    for w in workers:
        w._end(max(deadline - time.time(), 0.0))


class ProcessWorker:
    def __init__(self, none_stop: bool = False, name: tp.Optional[str] = None):
        ctx = worker_context()
        self._ctx = ctx
        self.none_stop = none_stop
        self.name = name or type(self).__name__
        self._started = ctx.Event()
        self._stop = ctx.Event()
        self._finished = ctx.Event()
        self._proc: tp.Optional[mp.process.BaseProcess] = None
        self._env: tp.Dict[str, str] = {}

    # -- lifecycle hooks (override) ---------------------------------------------

    def on_start(self) -> None:
        pass

    def do_work_once(self) -> None:
        raise NotImplementedError

    def on_finish(self) -> None:
        pass

    # -- control ----------------------------------------------------------------

    def start(self, timeout: float = 60.0) -> "ProcessWorker":
        """Start the child and wait until ``on_start`` has returned; raises
        ``TimeoutError`` (the child stopped) after ``timeout`` seconds, and
        ``RuntimeError`` if ``on_start`` raised."""
        return self.launch().wait_started(timeout)

    def launch(self) -> "ProcessWorker":
        """Start the child without waiting for it (``wait_started`` waits)."""
        self._env = dict(os.environ)
        self._proc = self._ctx.Process(target=self._run, name=self.name, daemon=False)
        self._proc.start()
        return self

    def wait_started(self, timeout: float) -> "ProcessWorker":
        if not self._started.wait(timeout):
            self.stop(1.0)
            raise TimeoutError(f"{self.name} did not start within {timeout}s")
        if self._finished.is_set():
            self.stop(5.0)
            raise RuntimeError(f"{self.name} failed in on_start (exit code {self.exitcode})")
        return self

    def request_stop(self) -> None:
        """Ask the loop to end after its current ``do_work_once``."""
        self._stop.set()

    def stop(self, timeout: float = 10.0) -> None:
        """Ask the loop to end, join the child, terminate it after ``timeout``."""
        stop_all([self], timeout)

    def _end(self, timeout: float) -> None:
        if self._proc is not None:
            self._proc.join(timeout)
            if self._proc.is_alive():
                self._proc.terminate()
                self._proc.join(5)
            if self._proc.is_alive():
                self._proc.kill()
                self._proc.join(5)

    def __enter__(self) -> "ProcessWorker":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def is_started(self) -> bool:
        return self._started.is_set()

    @property
    def is_finished(self) -> bool:
        return self._finished.is_set()

    @property
    def is_alive(self) -> bool:
        return self._proc is not None and self._proc.is_alive()

    @property
    def exitcode(self) -> tp.Optional[int]:
        return None if self._proc is None else self._proc.exitcode

    @property
    def pid(self) -> tp.Optional[int]:
        return None if self._proc is None else self._proc.pid

    # -- child body -------------------------------------------------------------

    def _run(self) -> None:
        from speechflow_torch.logging.server import attach_from_env

        adopt_environment(self._env)
        attach_from_env()
        try:
            self.on_start()
        except BaseException:
            traceback.print_exc()
            self._finished.set()
            self._started.set()  # the parent sees a finished worker and raises
            raise
        self._started.set()
        try:
            while not self._stop.is_set():
                try:
                    self.do_work_once()
                except Exception as e:
                    LOGGER.warning("%s: do_work_once raised %r", self.name, e)
                    traceback.print_exc()
                    if not self.none_stop:
                        break
                    time.sleep(0.5)
        finally:
            try:
                self.on_finish()
            finally:
                self._finished.set()
