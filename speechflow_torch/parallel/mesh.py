"""The device mesh of data-parallel training (counterpart of
``speechflow_tpu/parallel/mesh.py``).

JAX shards one program's batch over a mesh of devices and replicates the
parameters. The port runs one process per card, so its mesh is the ranks along
one ``data`` axis: ``shard_batch`` returns the rank's own slice (the batch it
holds), and ``replicate_state`` makes the parameters and buffers equal on
every rank by broadcasting rank 0's at the start.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from speechflow_torch.parallel.distributed import _dist, process_count, process_index

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate_state", "data_sharding"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks along named axes (one ``data`` axis by default)."""
    shape: tp.Dict[str, int]
    rank: int

    @property
    def axis_names(self) -> tp.Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def make_mesh(n_devices: tp.Optional[int] = None,
              shape: tp.Optional[tp.Dict[str, int]] = None) -> Mesh:
    """The ranks as a 1-D ``data`` mesh, or as ``shape``; its size must be the
    number of ranks (``n_devices``, if given, must be too)."""
    world = process_count()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"{n_devices} devices asked for, {world} ranks running "
                         "(one process per card)")
    shape = dict(shape or {"data": world})
    mesh = Mesh(shape, process_index())
    if mesh.size != world:
        raise ValueError(f"mesh {shape} has {mesh.size} places for {world} ranks")
    return mesh


def data_sharding(mesh: Mesh, axis: str = "data") -> str:
    """The axis the batch is split along."""
    if axis not in mesh.shape:
        raise KeyError(axis)
    return axis


def shard_batch(batch: tp.Any, mesh: tp.Optional[Mesh] = None, axis: str = "data") -> tp.Any:
    """The rank's slice of the global batch: what it holds."""
    return batch


@torch.no_grad()
def replicate_state(module: torch.nn.Module, mesh: tp.Optional[Mesh] = None
                    ) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (in place): one broadcast of
    them flattened per dtype and device; returns ``module``."""
    if process_count() == 1:
        return module
    groups: tp.Dict[tuple, list] = {}
    for t in (*module.parameters(), *module.buffers()):
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        _dist().broadcast(flat, src=0)
        at = 0
        for t in ts:
            t.data.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()
    return module
