"""The port's log aggregation (``speechflow_torch.logging``, the JAX package's
``logging/server.py`` over a local TCP socket in place of ZMQ): records of this
process, of a spawned ``ProcessWorker`` and of a second rank (a spawned process
that attaches through ``SPEECHFLOW_LOG_ADDR``) land in the experiment's log
file, and profiler events are summed up at its end. Processes are joined within
60 s and killed in ``finally``."""

import logging
import multiprocessing as mp
import os

import torch

from speechflow_torch.concurrency import ProcessWorker
from speechflow_torch.logging import (
    LoggingServer,
    attach_from_env,
    log_to_file,
    profiler_event,
    trace,
)
from speechflow_torch.logging.server import LOG_ADDR_ENV

torch.set_num_threads(1)
WAIT = 60


class _Talker(ProcessWorker):
    """Logs once when it starts, then idles."""

    def on_start(self) -> None:
        logging.getLogger("speechflow_torch").warning("worker %d says hello", os.getpid())

    def do_work_once(self) -> None:
        import time

        time.sleep(0.05)


def _second_rank(marker: str) -> None:
    attach_from_env()
    logging.getLogger("speechflow_torch").warning("rank 1 says %s", marker)
    profiler_event("rank_step", 0.25)
    logging.shutdown()


def test_records_of_a_worker_and_a_rank_land_in_the_log(tmp_path):
    log = tmp_path / "exp" / "experiment.log"
    rank = None
    worker = _Talker(name="talker")
    with LoggingServer(log) as server:
        assert os.environ[LOG_ADDR_ENV] == server.address
        logging.getLogger("speechflow_torch").warning("rank 0 says hi")
        profiler_event("rank_step", 0.5)
        try:
            worker.start(timeout=WAIT)
            rank = mp.get_context("spawn").Process(target=_second_rank, args=("bonjour",))
            rank.start()
            rank.join(WAIT)
            assert rank.exitcode == 0
        finally:
            worker.stop(timeout=5)
            if rank is not None and rank.is_alive():
                rank.kill()
                rank.join(5)
    assert LOG_ADDR_ENV not in os.environ
    text = log.read_text()
    assert "rank 0 says hi" in text and "rank 1 says bonjour" in text
    assert f"worker {worker.pid} says hello" in text and "talker" in text
    assert "rank_step: n=2 mean=375.00ms" in text
    assert len(server.pids) == 3
    assert not worker.is_alive and worker.exitcode is not None


class _Broken(ProcessWorker):
    def on_start(self) -> None:
        raise ValueError("no")


def test_process_worker_lifecycle():
    """``start`` waits for ``on_start``; a worker whose ``on_start`` raises is
    reported, not waited for."""
    import pytest

    w = _Broken()
    with pytest.raises(RuntimeError, match="on_start"):
        w.start(timeout=WAIT)
    assert not w.is_alive and w.is_finished


def test_helpers(tmp_path):
    try:
        raise KeyError("k")
    except KeyError:
        msg = trace("owner", "failed")
    assert msg.startswith("[owner] failed") and "KeyError" in msg
    handler = log_to_file(tmp_path / "a.log")
    try:
        logging.getLogger("speechflow_torch").warning("to the file")
    finally:
        logging.getLogger().removeHandler(handler)
        handler.close()
    assert "to the file" in (tmp_path / "a.log").read_text()
