"""The port's data plane (``speechflow_torch.server``: a data server process, its
workers and loaders over ``multiprocessing.connection``) against the JAX
package's ``tests/test_data_server.py`` cases, with real processes and sockets:
delivery counts over epochs, a ``Proxy`` over two servers, loaders over two
data configs, ``DataClient``, handlers that mutate samples in place, read-only
batch arrays, the Unix sockets removed after shutdown. The batches equal JAX's
``get_dataset_iterator`` (in-process) for the same sampler order; two loaders on
the shared sampler draw disjoint samples, and data-parallel loaders
(``shard``) split each global batch. Every test waits on processes with
timeouts of 60 s or less, and stops them in ``finally``.
"""

import collections
import glob
import os
import tempfile

import numpy as np
import pytest
import torch

from speechflow_torch.data.core.components import DataPipeline
from speechflow_torch.data.core.datasample import DataSample
from speechflow_torch.data.samplers import SimpleSampler
from speechflow_torch.scripts.train_tts import configs
from speechflow_torch.server import (
    DataClient,
    DataLoader,
    DataServer,
    LoaderBundle,
    Proxy,
    WorkerPool,
    get_dataset_iterator,
    init_data_loader,
    init_data_loader_from_configs,
    sample_key,
)
from speechflow_torch.server import transport as T
from speechflow_torch.server.helpers import server_payload

torch.set_num_threads(1)
N_SAMPLES, BATCH, WAIT = 60, 8, 60
SEGS = os.path.join(os.path.dirname(__file__), "data", "SEGS")
TOOL = "tests.tools.torch_mutating_handler"


@pytest.fixture(autouse=True, scope="module")
def _forget_the_tool_registrations():
    """The tool module registers ``PayloadCollate`` and ``mutate_payload_inplace`` in
    the port's process-wide registries when a pipeline here imports it: take them out
    after this file, so a file that runs next in the same worker sees the port's own
    (``test_torch_registries.py`` counts them)."""
    import sys

    from speechflow_torch.data.collate import COLLATES
    from speechflow_torch.data.core.registry import PipeRegistry
    from speechflow_torch.data.processors import HANDLERS

    yield
    COLLATES.pop("PayloadCollate", None)
    HANDLERS.pop("mutate_payload_inplace", None)
    PipeRegistry._registry.pop("mutate_payload_inplace", None)
    sys.modules.pop(TOOL, None)


def _pipeline(n: int = N_SAMPLES, pipe=(), speakers=None, prefix: str = "") -> DataPipeline:
    """Samples labelled ``prefix`` + index with a 64 x 64 payload of their index,
    the handlers ``pipe`` and ``PayloadCollate`` (``tests/tools/torch_mutating_handler``),
    a ``SimpleSampler``."""
    cfg = {"dataset": {"subsets": ["train"]}, "collate": {"type": "PayloadCollate"},
           "preproc": {"imports": [TOOL], "pipe": list(pipe)}}
    samples = [DataSample(label=f"{prefix}{i}", index=i,
                          additional={"payload": np.full((64, 64), float(i), np.float32)})
               for i in range(n)]
    singletons = {}
    if speakers:
        singletons["SpeakerIDSetter"] = {"speaker2id": {s: k for k, s in enumerate(speakers)},
                                         "lang2id": {}}
    dp = DataPipeline.from_info({"config": cfg, "subsets": ["train"], "alphabet": None,
                                 "singletons": singletons, "dataset_sizes": {"train": n}})
    dp.datasets = {"train": samples}
    dp.samplers = {"train": SimpleSampler().set_dataset(samples)}
    return dp


@pytest.fixture(scope="module")
def bundle():
    b = init_data_loader(_pipeline(), batch_size=BATCH, n_workers=2, prefetch_factor=4)
    try:
        yield b
    finally:
        b.shutdown()


def _jax_batches(n: int, batch: int) -> list:
    """(labels, is_last) of JAX's in-process ``get_dataset_iterator`` over ``n`` bare
    samples with its ``SimpleSampler``: one epoch."""
    from speechflow_tpu.data.core import DataSample as JSample
    from speechflow_tpu.data.core import Dataset
    from speechflow_tpu.data.core.components import DataPipeline as JDP
    from speechflow_tpu.io import Config
    from speechflow_tpu.server import get_dataset_iterator as jax_iterator

    jdp = JDP(Config({"dataset": {"subsets": ["train"]},
                      "sampler": {"train": {"type": "SimpleSampler"}},
                      "preproc": {"pipe": []}}))
    jdp.init_components(datasets={"train": Dataset([JSample(label=str(i), index=i)
                                                     for i in range(n)])})
    return [([s.label for s in b.data_samples], b.is_last)
            for b in jax_iterator(jdp, "train", batch)]


def test_delivery_counts(bundle):
    """Three epochs: every label exactly three times, each epoch ending at ``is_last``;
    the first epoch's batches are JAX's ``get_dataset_iterator``'s."""
    counts = collections.Counter()
    epochs = []
    for _ in range(3):
        epochs.append([(b.keys, b.is_last) for b in bundle["train"]])
        for keys, _ in epochs[-1]:
            assert keys
            counts.update(keys)
        assert sum(len(k) for k, _ in epochs[-1]) == N_SAMPLES
    assert set(counts.values()) == {3} and len(counts) == N_SAMPLES
    assert epochs[0] == _jax_batches(N_SAMPLES, BATCH)


def test_dataset_iterator_follows_jax():
    """The port's in-process ``get_dataset_iterator``: JAX's batches."""
    assert [(b.keys, b.is_last) for b in get_dataset_iterator(_pipeline(20), "train", 6)] \
        == _jax_batches(20, 6)


def test_collated_batch_equals_jax(monkeypatch):
    """The debug TTS data config over SEGS: the server's first train batch of 2 (a
    worker's handlers and ``TTSCollate``) equals JAX's ``get_dataset_iterator``'s."""
    import dataclasses

    from speechflow_tpu.data.core.components import DataPipeline as JDP
    from speechflow_tpu.data.core.singleton import Singleton
    from speechflow_tpu.io import Config
    from speechflow_tpu.server import get_dataset_iterator as jax_iterator

    monkeypatch.delenv("SFTPU_DUMP_CACHE", raising=False)
    _, data_cfg = configs("debug", data_root=SEGS)
    Singleton.clear()
    try:
        want = next(jax_iterator(JDP(Config(data_cfg)).init_components(), "train", 2))
    finally:
        Singleton.clear()
    with init_data_loader(DataPipeline.from_config(data_cfg), subsets=["train"], batch_size=2,
                          n_workers=1, prefetch_factor=1) as b:
        got = b["train"].next_item(timeout=WAIT)
    assert got.keys == [s.file_path for s in want.data_samples]
    ref, checked = want.collated_samples, 0
    for f in dataclasses.fields(got.collated):
        value = getattr(got.collated, f.name)
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(value, getattr(ref, f.name), err_msg=f.name)
            checked += 1
    assert checked >= 15


def test_shared_sampler_gives_loaders_disjoint_samples(bundle):
    """Two loaders on one server draw from its shared sampler: disjoint samples."""
    front = bundle.addrs[0]
    key = bundle["train"].authkey
    a = DataLoader(front, "train", 4, key, prefetch_factor=2).start()
    b = DataLoader(front, "train", 4, key, prefetch_factor=2).start()
    try:
        seen = [set(), set()]
        for _ in range(3):
            seen[0] |= set(a.next_item(WAIT).keys)
            seen[1] |= set(b.next_item(WAIT).keys)
        assert len(seen[0]) == len(seen[1]) == 12 and not seen[0] & seen[1]
    finally:
        a.stop()
        b.stop()


def test_data_parallel_loaders_split_each_global_batch(bundle):
    """Loaders of two ranks (``shard``): for each request the server draws one global
    batch of 2 x 3 and rank r gets its r-th half: consecutive samples of the sampler
    a step, rank 0's first."""
    front, key = bundle.addrs[0], bundle["train"].authkey
    ranks = [DataLoader(front, "train", 3, key, prefetch_factor=3, shard=(r, 2)).start()
             for r in (1, 0)]  # rank 1 asks first
    try:
        parts = [[ld.next_item(WAIT).keys for _ in range(5)] for ld in reversed(ranks)]
    finally:
        for ld in ranks:
            ld.stop()
    steps = [[int(x) for x in parts[0][k] + parts[1][k]] for k in range(5)]
    for k, step in enumerate(steps):
        # six samples in sampler order, fewer where the epoch ends (the sampler's
        # last batch is short); each rank holds its half
        assert step == list(range(step[0], step[0] + len(step))), step
        assert len(step) == 6 or step[-1] == N_SAMPLES - 1, step
        assert len(parts[0][k]) == (len(step) + 1) // 2
        if k:
            assert step[0] == (steps[k - 1][-1] + 1) % N_SAMPLES


def test_connection_rate_and_device_iterator(bundle):
    """``test_connection`` counts batches, samples and bytes a second; ``device_iterator``
    yields each batch with its arrays as tensors on the device, one moved ahead."""
    rate = bundle["train"].test_connection(duration_s=0.5)
    assert rate["n_batches"] > 0 and rate["samples_per_s"] > 0 and rate["mb_per_batch"] > 0.1
    pairs = list(bundle["train"].device_iterator("cpu", n_batches=2))
    assert len(pairs) == 2
    for batch, moved in pairs:
        assert isinstance(moved["payload"], torch.Tensor)
        np.testing.assert_array_equal(moved["payload"].numpy(), batch.collated["payload"])


def test_standalone_data_client(bundle):
    with DataClient(bundle.addrs[0], bundle["train"].authkey) as client:
        assert client.n_workers == 2
        assert client.find_info("subsets") == ["train"]
        assert client.find_info("no_such_key", default="d") == "d"
        assert client.find_section("collate") == {"type": "PayloadCollate"}
        assert client.status()["workers"] == 2


def test_a_client_without_the_key_is_refused(bundle):
    with pytest.raises(Exception):
        DataClient(bundle.addrs[0], b"not the key", timeout_s=5)


def test_loader_batches_are_readonly_views(bundle):
    """A loader's arrays are read-only views of the received frames: copy to write."""
    arr = bundle["train"].next_item(WAIT).collated["payload"]
    assert isinstance(arr, np.ndarray) and not arr.flags.writeable
    with pytest.raises((ValueError, RuntimeError)):
        arr[0, 0, 0] = 1.0
    arr.copy()[0, 0, 0] = 1.0


def test_worker_handlers_may_mutate_in_place():
    """The workers hand their handlers writable samples (``preproc.imports`` registers
    a handler that adds 1 in place); at shutdown every process stops and the Unix
    sockets' files go."""
    before = set(glob.glob(os.path.join(tempfile.gettempdir(), "sftorch-*.sock")))
    b = init_data_loader(_pipeline(8, pipe=["mutate_payload_inplace"]), batch_size=4,
                         n_workers=1, prefetch_factor=2)
    try:
        batch = b["train"].next_item(WAIT)
        socks = [a[len("ipc://"):] for a in b.addrs if a.startswith("ipc://")]
        assert socks and all(os.path.exists(x) for x in socks)
    finally:
        b.shutdown()
    assert batch.keys == ["0", "1", "2", "3"]
    np.testing.assert_array_equal(batch.collated["payload_sum"],
                                  (np.arange(4) + 1.0) * 64 * 64)
    np.testing.assert_array_equal(batch.collated["payload"][:, 0, 0], np.arange(4) + 1.0)
    assert not any(os.path.exists(x) for x in socks)
    assert set(glob.glob(os.path.join(tempfile.gettempdir(), "sftorch-*.sock"))) <= before
    assert not any(p.is_alive for p in (*b.servers, *b.pools[0].workers))


def test_proxy_fans_in_two_servers():
    """Two servers with their own samples and speakers behind a ``Proxy``: its info
    has both speakers, and one loader's batches come from both."""
    servers, pools, addrs = [], [], []
    key = os.urandom(16)
    proxy = None
    try:
        for prefix, spk in (("a", ["spk_a"]), ("b", ["spk_b"])):
            front, back = T.local_addr("front"), T.local_addr("back")
            addrs += [front, back]
            servers.append(DataServer(front, back, server_payload(_pipeline(12, speakers=spk,
                                                                            prefix=prefix)),
                                      key, n_workers_hint=1).launch())
            pools.append(WorkerPool(back, key, 1))
            pools[-1].workers[0].launch()
        for proc in (*servers, *(p.workers[0] for p in pools)):
            proc.wait_started(WAIT)
        proxy_front = T.local_addr("proxy")
        addrs.append(proxy_front)
        proxy = Proxy(proxy_front, addrs[0::2][:2], key).start(WAIT)
        loader = DataLoader(proxy_front, "train", 4, key, prefetch_factor=4).start()
        try:
            assert set(loader.info["singletons"]["SpeakerIDSetter"]["speaker2id"]) == \
                {"spk_a", "spk_b"}
            labels = set()
            for _ in range(6):
                labels |= set(loader.next_item(WAIT).keys)
        finally:
            loader.stop()
        assert any(x.startswith("a") for x in labels) and any(x.startswith("b") for x in labels)
    finally:
        LoaderBundle({}, servers, pools, proxy, addrs).shutdown()


def test_multi_config_loader():
    """``init_data_loader_from_configs`` over the English and the Russian half of
    SEGS: merged speaker and language ids, batches of both corpora labelled in them."""
    cfgs = []
    for lang in ("EN", "RU"):
        _, data_cfg = configs("debug", data_root=os.path.join(SEGS, lang))
        data_cfg["dataset"]["max_num_samples"] = 3
        cfgs.append(data_cfg)
    with init_data_loader_from_configs(cfgs, subsets=["train"], batch_size=2,
                                       n_workers_per_server=1, prefetch_factor=2) as b:
        spk = b["train"].info["singletons"]["SpeakerIDSetter"]
        assert len(spk["lang2id"]) == 2
        langs = set()
        for _ in range(4):
            batch = b["train"].next_item(WAIT)
            ids = batch.collated.lang_id.tolist()
            langs |= set(ids)
        assert langs == set(spk["lang2id"].values())
