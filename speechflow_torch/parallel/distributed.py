"""Data-parallel training over processes (counterpart of
``speechflow_tpu/parallel/distributed.py``).

The port runs one process per card (a rank), joined by
``torch.distributed``. ``init_distributed`` reads JAX's environment contract,
set by whoever launches the ranks:

    SPEECHFLOW_COORDINATOR    host:port of rank 0's rendezvous
    SPEECHFLOW_NUM_PROCESSES  the number of ranks
    SPEECHFLOW_PROCESS_ID     this process's rank

and is a no-op without it (one process). The ranks first tell each other
which cards they see (the host name and ``CUDA_VISIBLE_DEVICES``) through the
rendezvous store, so each knows how many ranks share its cards and which of
them it is (``local_placement``). The backend is ``nccl`` where every rank has
a card of its own (the ``i``-th rank on a set of cards takes card ``i``) and
``gloo`` where ranks outnumber the cards they share (NCCL refuses two ranks
on one device; gloo reduces CUDA tensors in place on the card) or run on the
CPU. Collectives time out after ``timeout_s`` (120 s, not gloo's 30
minutes): a rank that raised leaves the others waiting no longer than that.

A trainer with ``use_mesh`` takes its steps inside ``data_parallel_step()``.
There the losses' normalizers are those of the global batch, as JAX's one
program over the sharded batch has them: ``global_count`` turns a rank's count
of valid elements into the mean of the ranks' counts, so that a rank's
``sum / global_count`` averaged over the ranks is the global batch's masked
mean, and ``norm_ratio`` does the same for a ratio of norms (the STFT loss's
spectral convergence). ``mean_over_ranks`` averages gradients (once per
optimizer step) and logged losses. Each rank holds its own slice of the global
batch, so ``global_batch`` returns the batch it is given.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import socket
import typing as tp

import torch

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["init_distributed", "is_distributed", "process_index", "process_count",
           "backend", "global_batch", "broadcast_bytes", "shutdown_distributed",
           "data_parallel_step", "in_data_parallel_step", "global_count", "norm_ratio",
           "mean_over_ranks", "local_placement", "choose_backend", "ENV_COORDINATOR",
           "ENV_NUM_PROCESSES", "ENV_PROCESS_ID"]

ENV_COORDINATOR = "SPEECHFLOW_COORDINATOR"
ENV_NUM_PROCESSES = "SPEECHFLOW_NUM_PROCESSES"
ENV_PROCESS_ID = "SPEECHFLOW_PROCESS_ID"
_STEP = {"active": False}


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def local_placement(hosts: tp.Sequence[str], rank: int) -> tp.Tuple[int, int]:
    """(ranks that see ``rank``'s cards, its index among them in rank order), from
    what every rank sees (its host and visible cards) in rank order."""
    mine = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    return len(mine), mine.index(rank)


def choose_backend(device: tp.Union[str, torch.device, None], local_ranks: int,
                   cards: int) -> str:
    """nccl where each of the ``local_ranks`` ranks that see these ``cards`` can
    have one of its own, else gloo (and gloo on the CPU)."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type == "cpu") or cards == 0:
        return "gloo"
    return "nccl" if local_ranks <= cards else "gloo"


def _hosts(store, rank: int, world: int) -> tp.List[str]:
    """Every rank's host name and visible cards in rank order, exchanged through
    ``store``."""
    seen = f"{socket.gethostname()}|{os.environ.get('CUDA_VISIBLE_DEVICES', '*')}"
    store.set(f"speechflow/host/{rank}", seen)
    return [store.get(f"speechflow/host/{r}").decode() for r in range(world)]


def init_distributed(coordinator: tp.Optional[str] = None,
                     num_processes: tp.Optional[int] = None,
                     process_id: tp.Optional[int] = None,
                     device: tp.Union[str, torch.device, None] = None,
                     timeout_s: float = 120.0) -> tp.Tuple[int, int]:
    """Join the process group from the arguments or the environment contract;
    returns (rank, world size), (0, 1) without a coordinator. With nccl each rank
    takes the card of its index among the ranks that see the same cards."""
    if _initialized():
        return process_index(), process_count()
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if coordinator is None:
        return 0, 1
    world = int(num_processes if num_processes is not None
                else os.environ.get(ENV_NUM_PROCESSES, 1))
    rank = int(process_id if process_id is not None else os.environ.get(ENV_PROCESS_ID, 0))
    dist = _dist()
    host, port = coordinator.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=timeout)
    local_ranks, local_index = local_placement(_hosts(store, rank, world), rank)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    name = choose_backend(device, local_ranks, cards)
    if name == "nccl":
        torch.cuda.set_device(local_index)
    dist.init_process_group(name, store=store, world_size=world, rank=rank, timeout=timeout)
    LOGGER.info("torch.distributed: rank %d of %d (%d of %d on its cards), backend %s",
                rank, world, local_index, local_ranks, name)
    return rank, world


def shutdown_distributed() -> None:
    """Leave the process group (a no-op outside one)."""
    if _initialized():
        _dist().destroy_process_group()


def is_distributed() -> bool:
    return process_count() > 1


def process_index() -> int:
    return _dist().get_rank() if _initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if _initialized() else 1


def backend() -> tp.Optional[str]:
    """The process group's backend, None outside one."""
    return str(_dist().get_backend()) if _initialized() else None


def global_batch(tree: tp.Any, mesh=None, axis: str = "data") -> tp.Any:
    """The rank's part of the global batch: the batch it holds, unchanged."""
    return tree


def broadcast_bytes(payload: tp.Optional[bytes], max_len: int = 1024) -> bytes:
    """``payload`` of rank 0 on every rank (the others pass None). ``max_len``
    is the JAX package's fixed buffer; the object broadcast here has none, so
    a payload of any length goes through."""
    if not is_distributed():
        assert payload is not None
        return payload
    box = [payload if process_index() == 0 else None]
    _dist().broadcast_object_list(box, src=0)
    return box[0]


@contextlib.contextmanager
def data_parallel_step(active: bool = True):
    """Inside (when ``active`` and there is more than one rank): the normalizers
    below are the global batch's."""
    saved = _STEP["active"]
    _STEP["active"] = active and is_distributed()
    try:
        yield
    finally:
        _STEP["active"] = saved


def in_data_parallel_step() -> bool:
    return _STEP["active"]


def _all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    out = t.detach().clone()
    _dist().all_reduce(out)
    return out


def global_count(count: torch.Tensor) -> torch.Tensor:
    """A loss's normalizer (a count of valid elements): in a data-parallel step,
    the mean of the ranks' counts, so that each rank's ``sum / global_count``
    averaged over the ranks is ``sum of sums / sum of counts``; else ``count``."""
    if not _STEP["active"]:
        return count
    return _all_reduce_sum(count) / process_count()


def norm_ratio(diff: torch.Tensor, ref: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``||diff|| / max(||ref||, eps)`` over the global batch (``ref`` takes no
    gradient). In a data-parallel step every rank returns the global value, with
    a gradient whose mean over the ranks is the global one's."""
    if not _STEP["active"]:
        return torch.linalg.norm(diff) / torch.clamp(torch.linalg.norm(ref.detach()), min=eps)
    a = torch.sum(diff * diff)
    both = _all_reduce_sum(torch.stack([a.detach(), torch.sum(ref.detach() ** 2)]))
    total, ref_sq = both[0], both[1]
    value = torch.sqrt(total) / torch.clamp(torch.sqrt(ref_sq), min=eps)
    # d value / d a = value / (2 total), for each rank's share a of the total
    slope = value / (2.0 * torch.clamp(total, min=torch.finfo(total.dtype).tiny))
    return value + process_count() * slope * (a - a.detach())


def mean_over_ranks(tensors: tp.Sequence[torch.Tensor]) -> tp.List[torch.Tensor]:
    """Each tensor averaged over the ranks: one all-reduce of them flattened
    (grouped by dtype and device), returned as new tensors."""
    if not is_distributed():
        return list(tensors)
    out: tp.List[tp.Optional[torch.Tensor]] = [None] * len(tensors)
    groups: tp.Dict[tuple, tp.List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    world = process_count()
    for idx in groups.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        _dist().all_reduce(flat)
        flat /= world
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[offset:offset + n].view_as(tensors[i])
            offset += n
    return out  # type: ignore[return-value]
