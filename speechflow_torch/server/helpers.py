"""Wiring the data plane (counterpart of ``speechflow_tpu/server/helpers.py``).

- ``init_data_loader``: a ``DataServer`` process, its ``WorkerPool`` and a
  ``DataLoader`` per subset over a built pipeline, on same-host sockets;
- ``init_data_loader_distributed``: rank 0 of a process group hosts the server
  and its workers on TCP and broadcasts the address (and the connection key)
  to every rank; each rank's loaders ask for their share of the global batch
  (``shard=(rank, world)``);
- ``init_data_loader_from_configs``: one server per data config behind a
  ``Proxy``, the singletons' states merged first so every server labels
  speakers and languages alike;
- ``get_dataset_iterator``: the same batches in this process, with no server.

A ``LoaderBundle`` is the loaders by subset (a dict); ``shutdown`` (also
``close``) stops the loaders, the workers and the server, and removes the
Unix sockets' files.
"""

from __future__ import annotations

import logging
import os
import pickle
import socket
import typing as tp

from speechflow_torch.concurrency.process_worker import stop_all
from speechflow_torch.server import transport as T
from speechflow_torch.server.loader import Batch, DataLoader
from speechflow_torch.server.server import DataServer, sample_key
from speechflow_torch.server.worker import WorkerPool

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["init_data_loader", "init_data_loader_distributed",
           "init_data_loader_from_configs", "get_dataset_iterator", "LoaderBundle",
           "find_free_port", "server_payload"]

find_free_port = T.find_free_port


class LoaderBundle(dict):
    """Subset -> ``DataLoader``, with the processes behind them."""

    def __init__(self, loaders: tp.Mapping[str, DataLoader], servers: tp.Sequence = (),
                 pools: tp.Sequence[WorkerPool] = (), proxy=None,
                 addrs: tp.Sequence[str] = (), server=None, pool=None):
        """``server`` and ``pool`` (JAX's keywords) add one server and one pool."""
        super().__init__(loaders)
        self.servers = list(servers) + ([server] if server is not None else [])
        self.pools = list(pools) + ([pool] if pool is not None else [])  # none off rank 0
        self.proxy = proxy
        self.addrs = list(addrs)

    def shutdown(self, timeout: float = 2.0) -> None:
        """Stop the loaders, then the proxy and the servers, then the workers (one
        in the middle of a batch nobody will read is terminated after ``timeout``)."""
        for ld in self.values():
            ld.stop()
        stop_all(([self.proxy] if self.proxy is not None else []) + self.servers, timeout)
        stop_all([w for pool in self.pools for w in pool.workers], timeout)
        for addr in self.addrs:
            T.unlink_addr(addr)

    close = shutdown

    def __enter__(self) -> "LoaderBundle":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def server_payload(pipeline) -> bytes:
    """What a ``DataServer`` needs of a built pipeline: its info and samplers
    (which hold the datasets)."""
    return pickle.dumps({"info": pipeline.get_info(), "samplers": pipeline.samplers},
                        protocol=5)


def _start_servers(pipelines: tp.Sequence, fronts: tp.Sequence[str], backs: tp.Sequence[str],
                   authkey: bytes, n_workers: int, synchronize_loaders: bool = False,
                   timeout: float = 300.0) -> tp.Tuple[list, list]:
    """A server and its worker pool per pipeline, every process started at once;
    returns when the servers listen. The workers join their server when they have
    imported their modules and rebuilt the pipeline (seconds), while the caller goes
    on; tasks queue at the server until then."""
    servers = [DataServer(f, b, server_payload(dp), authkey, n_workers_hint=n_workers,
                          synchronize_loaders=synchronize_loaders)
               for dp, f, b in zip(pipelines, fronts, backs)]
    pools = [WorkerPool(b, authkey, n_workers) for b in backs]
    try:
        for srv, pool in zip(servers, pools):
            srv.launch()
            for w in pool.workers:
                w.launch()
        for srv in servers:
            srv.wait_started(timeout)
    except BaseException:
        for pool in pools:
            pool.stop()
        for srv in servers:
            srv.stop()
        raise
    return servers, pools


def _loaders(front: str, authkey: bytes, subsets: tp.Sequence[str], batch_size: int,
             shard=None, **kwargs) -> tp.Dict[str, DataLoader]:
    loaders: tp.Dict[str, DataLoader] = {}
    try:
        for s in subsets:
            loaders[s] = DataLoader(front, s, batch_size, authkey, shard=shard, **kwargs).start()
    except BaseException:
        for ld in loaders.values():
            ld.stop()
        raise
    return loaders


def _pipeline_of(config_path, value_select):
    """The initialised pipeline of a data config file."""
    from speechflow_torch.data.core.components import DataPipeline

    if config_path is None:
        raise ValueError("pass a built pipeline or a config_path")
    return DataPipeline.init_from_config(config_path, value_select=value_select).init_components()


def init_data_loader(pipeline=None, subsets: tp.Optional[tp.Sequence[str]] = None,
                     batch_size: int = 8, n_workers: int = 2, prefetch_factor: int = 8,
                     min_prefetch: int = 2, drop_non_full: bool = False,
                     min_batch_size: int = 1, synchronize_loaders: bool = False,
                     server_addr: tp.Optional[str] = None,
                     config_path: tp.Optional[tp.Union[str, os.PathLike]] = None,
                     value_select: tp.Optional[tp.Sequence[str]] = None) -> LoaderBundle:
    """A server, ``n_workers`` workers and a loader per subset of a built
    pipeline (``DataPipeline.from_config``), or of the pipeline of the data
    config file ``config_path`` read with ``value_select``."""
    if pipeline is None:
        pipeline = _pipeline_of(config_path, value_select)
    subsets = list(subsets or pipeline.samplers)
    authkey = os.urandom(16)
    front, back = server_addr or T.local_addr("front"), T.local_addr("back")
    servers, pools = _start_servers([pipeline], [front], [back], authkey, n_workers,
                                    synchronize_loaders)
    try:
        loaders = _loaders(front, authkey, subsets, batch_size,
                           prefetch_factor=prefetch_factor, min_prefetch=min_prefetch,
                           drop_non_full=drop_non_full, min_batch_size=min_batch_size)
    except BaseException:
        LoaderBundle({}, servers, pools, addrs=(front, back)).shutdown()
        raise
    return LoaderBundle(loaders, servers, pools, addrs=(front, back))


def _host() -> str:
    host = os.environ.get("SPEECHFLOW_DATASERVER_HOST")
    if host:
        return host
    try:  # a routable address of this host; a host with loopback only falls back
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def init_data_loader_distributed(pipeline=None, subsets: tp.Optional[tp.Sequence[str]] = None,
                                 batch_size: int = 8, n_workers: int = 2,
                                 prefetch_factor: int = 8,
                                 min_prefetch: tp.Union[int, tp.Mapping[str, int]] = 2,
                                 drop_non_full: bool = False, min_batch_size: int = 1,
                                 host: tp.Optional[str] = None,
                                 config_path: tp.Optional[tp.Union[str, os.PathLike]] = None,
                                 value_select: tp.Optional[tp.Sequence[str]] = None
                                 ) -> LoaderBundle:
    """Rank 0 (which passes the built pipeline, or a ``config_path`` to build it
    from) hosts the server and its workers for every rank; every rank gets
    loaders that draw ``batch_size`` samples, its share of a global batch of
    ``batch_size x world``. ``min_prefetch`` may map each subset to its own (0
    for a subset it does not name). One process: ``init_data_loader``."""
    from speechflow_torch.parallel.distributed import (
        broadcast_bytes,
        process_count,
        process_index,
    )

    world, rank = process_count(), process_index()
    if world == 1:
        return init_data_loader(pipeline, subsets, batch_size, n_workers, prefetch_factor,
                                min_prefetch if isinstance(min_prefetch, int) else 2,
                                drop_non_full, min_batch_size, config_path=config_path,
                                value_select=value_select)
    servers, pools = [], []
    blob = None
    if rank == 0:
        if pipeline is None:
            if config_path is None:
                raise ValueError("rank 0 hosts the data server: pass it the pipeline "
                                 "or a config_path")
            pipeline = _pipeline_of(config_path, value_select)
        authkey = os.urandom(16)
        h = host or _host()
        front, back = T.tcp_addr(h), T.tcp_addr(h)
        servers, pools = _start_servers([pipeline], [front], [back], authkey, n_workers)
        blob = pickle.dumps((front, authkey, list(subsets or pipeline.samplers)))
    try:
        front, authkey, all_subsets = pickle.loads(broadcast_bytes(blob))
        subsets = list(subsets or all_subsets)
        loaders = {}
        for s in subsets:
            mp = min_prefetch if isinstance(min_prefetch, int) else min_prefetch.get(s, 0)
            loaders.update(_loaders(front, authkey, [s], batch_size, shard=(rank, world),
                                    prefetch_factor=prefetch_factor, min_prefetch=mp,
                                    drop_non_full=drop_non_full,
                                    min_batch_size=min_batch_size))
    except BaseException:
        for pool in pools:
            pool.stop()
        for server in servers:
            server.stop()
        raise
    return LoaderBundle(loaders, servers, pools)


def init_data_loader_from_configs(data_configs: tp.Optional[tp.Sequence[tp.Mapping]] = None,
                                  subsets: tp.Optional[tp.Sequence[str]] = None,
                                  batch_size: int = 8, n_workers_per_server: int = 2,
                                  prefetch_factor: int = 8,
                                  config_paths: tp.Optional[tp.Sequence] = None,
                                  value_select: tp.Optional[tp.Sequence[str]] = None
                                  ) -> LoaderBundle:
    """One server (and its workers) per data config (``data_configs``, or the
    files ``config_paths`` read with ``value_select``), a ``Proxy`` in front of
    them, and a loader per subset; the pipelines adopt their merged singleton
    states before their servers start (a speaker's id is the same in every
    corpus's batches)."""
    from speechflow_torch.data.core.components import DataPipeline
    from speechflow_torch.server.proxy import Proxy

    if data_configs is None:
        pipelines = [_pipeline_of(path, value_select) for path in config_paths or ()]
    else:
        pipelines = [DataPipeline.from_config(cfg) for cfg in data_configs]
    if not pipelines:
        raise ValueError("pass data_configs or config_paths")
    if len(pipelines) == 1:
        return init_data_loader(pipelines[0], subsets, batch_size, n_workers_per_server,
                                prefetch_factor)
    merged = DataPipeline.aggregate_info([dp.get_info() for dp in pipelines])
    for dp in pipelines:
        dp.adopt_shared_state(merged)
    authkey = os.urandom(16)
    fronts = [T.local_addr("front") for _ in pipelines]
    backs = [T.local_addr("back") for _ in pipelines]
    addrs = [*fronts, *backs]
    servers, pools = _start_servers(pipelines, fronts, backs, authkey, n_workers_per_server)
    proxy = None
    try:
        proxy_front = T.local_addr("proxy")
        addrs.append(proxy_front)
        proxy = Proxy(proxy_front, fronts, authkey).start(300)
        loaders = _loaders(proxy_front, authkey, list(subsets or pipelines[0].samplers),
                           batch_size, prefetch_factor=prefetch_factor)
    except BaseException:
        LoaderBundle({}, servers, pools, proxy, addrs).shutdown()
        raise
    return LoaderBundle(loaders, servers, pools, proxy, addrs)


def get_dataset_iterator(pipeline, subset: str = "train", batch_size: int = 8
                         ) -> tp.Iterator[Batch]:
    """One epoch of ``Batch`` records drawn and processed in this process."""
    process = pipeline.process
    while True:
        samples, is_last = pipeline.samplers[subset].sampling(batch_size)
        kept = [d for d in (process.sample(s) for s in samples) if d is not None]
        if kept:
            yield Batch(process.collate_fn(kept), [sample_key(s) for s in kept], is_last)
        if is_last:
            return
