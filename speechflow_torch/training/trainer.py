"""The training loop (counterpart of ``speechflow_tpu/training/trainer.py``).

``batch_processor(batch) -> (inputs, targets)``; ``model(inputs)``;
``criterion(outputs, targets, step) -> {name: loss}``, summed except the
names that contain ``constant`` (logged only); one ``Optimizer.step`` per
micro-batch (``training.optimizer``: NaN guard, clip, accumulation, windows);
periodic validation, TensorBoard scalars and checkpoints through
``ExperimentSaver``. The model runs in ``train()`` mode in both steps: the
JAX trainer validates with the model's training call too (``_val_step``
calls ``model(inputs)``), which for the acoustic model is the teacher-forced
call with dropout; validation only runs it without gradients.

Mixed precision is ``torch.autocast(bfloat16)`` over the model's call with
float32 master weights, optimizer state and gradients; the outputs are cast
to float32 before the criterion, as the JAX trainer casts them
(``_cast_floats``).

``use_mesh`` is data-parallel training over the ranks of a process group
(``parallel.distributed``; one process, no group: a plain step). Each rank
holds its slice of the global batch; the parameters and buffers start as rank
0's (``replicate_state``) and each rank draws its dropout and noise from
torch's generator seeded by (seed, rank). A step runs inside
``data_parallel_step``, so the losses divide by the global batch's counts; the
gradients are averaged over the ranks once per optimizer step (after the last
micro-batch's backward, ``Optimizer.reduce_grads``), which is the gradient of
JAX's one program over the global batch, and so are the logged losses. Only
rank 0 writes TensorBoard and checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from speechflow_torch.convert import load_nnx_state, nnx_from_module
from speechflow_torch.parallel import distributed as dist
from speechflow_torch.parallel.mesh import make_mesh, replicate_state
from speechflow_torch.training.optimizer import Optimizer, OptimizerConfig, build_optimizer
from speechflow_torch.training.saver import ExperimentSaver

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["Trainer", "TrainerConfig"]


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int = 1000
    log_every: int = 50
    val_every: int = 500
    ckpt_every: int = 1000
    val_batches: int = 8
    use_mesh: bool = False        # data parallel over the process group's ranks
    mixed_precision: bool = False  # bf16 compute with fp32 master weights
    seed: int = 0


def _cast_floats(tree, dtype: torch.dtype):
    """Cast every floating tensor of a nested dict/list/tuple that is narrower than
    ``dtype`` up to it (a float64 model's outputs stay float64)."""
    if isinstance(tree, torch.Tensor):
        wider = tree.is_floating_point() and torch.finfo(tree.dtype).bits < torch.finfo(dtype).bits
        return tree.to(dtype) if wider else tree
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, dtype) for v in tree)
    return tree


def _sum_losses(losses: tp.Mapping[str, torch.Tensor]):
    total = 0.0
    for name, val in losses.items():
        if "constant" not in name:
            total = total + val
    return total


def _place(tree, device: torch.device):
    """Numpy arrays and tensors of a nested dict/list/dataclass onto ``device``."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.require(tree, requirements=("C", "W"))).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _place(getattr(tree, f.name), device)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, device) for v in tree)
    return tree


def autocast(device: torch.device, enabled: bool):
    """bf16 autocast on ``device`` when ``enabled``, else nothing."""
    if not enabled:
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=torch.bfloat16)


def batch_getter(loader) -> tp.Callable:
    """``loader.next_batch`` where there is one, else the next item of an iterator."""
    if hasattr(loader, "next_batch"):
        return loader.next_batch
    it = iter(loader)
    return lambda: next(it)


def summary_writer(tb_dir: tp.Optional[tp.Union[str, Path]]):
    """A TensorBoard writer for ``tb_dir`` (None for None, and on ranks other
    than 0); raises ImportError where the machine has no TensorBoard rather
    than skip the logging."""
    if tb_dir is None or dist.process_index() != 0:
        return None
    from torch.utils.tensorboard import SummaryWriter

    return SummaryWriter(str(tb_dir))


def data_parallel(cfg: TrainerConfig, modules: tp.Sequence[nn.Module],
                  optimizers: tp.Sequence[Optimizer]):
    """``use_mesh`` with more than one rank: the modules' state made rank 0's,
    the optimizers averaging their gradients over the ranks, torch's generator
    seeded by (seed, rank). Returns the mesh (None without ``use_mesh``)."""
    if not cfg.use_mesh:
        return None
    mesh = make_mesh()
    if mesh.size > 1:
        for module in modules:
            replicate_state(module, mesh)
        for opt in optimizers:
            opt.reduce_grads = dist.mean_over_ranks
        torch.manual_seed(cfg.seed * 100003 + mesh.rank)
        LOGGER.info("data parallel: rank %d of %d, backend %s", mesh.rank, mesh.size,
                    dist.backend())
    return mesh


def ranks_mean(metrics: tp.Dict[str, torch.Tensor]) -> tp.Dict[str, torch.Tensor]:
    """Each 0-d value averaged over the ranks in float32, or in its own dtype where
    that is wider (one all-reduce a dtype; as it is on one)."""
    if not dist.is_distributed():
        return metrics
    keys = list(metrics)
    vals = [torch.as_tensor(metrics[k]).reshape(()) for k in keys]
    vals = dist.mean_over_ranks([v.to(torch.promote_types(v.dtype, torch.float32))
                                 for v in vals])
    return dict(zip(keys, vals))


class Trainer:
    def __init__(self, model: nn.Module, criterion: tp.Callable,
                 batch_processor: tp.Callable,
                 optimizer_config: tp.Optional[OptimizerConfig] = None,
                 config: tp.Optional[TrainerConfig] = None,
                 saver: tp.Optional[ExperimentSaver] = None,
                 tb_dir: tp.Optional[tp.Union[str, Path]] = None):
        self.model = model
        self.criterion = criterion
        self.batch_processor = batch_processor
        self.cfg = config or TrainerConfig()
        self.opt_cfg = optimizer_config or OptimizerConfig()
        self.saver = saver
        self.global_step = 0
        self.optimizer = build_optimizer(self.opt_cfg, model)
        self.mesh = data_parallel(self.cfg, [model], [self.optimizer])
        self._tb = summary_writer(tb_dir)
        self.device = next(model.parameters()).device

    def _forward(self, inputs):
        with autocast(self.device, self.cfg.mixed_precision):
            return self.model(inputs)

    # -- step API ---------------------------------------------------------------

    def training_step(self, batch) -> tp.Dict[str, torch.Tensor]:
        """One micro-batch (an optimizer step every ``grad_accum``); returns
        {name: detached 0-d tensor} (``float(v)`` fetches one)."""
        self.model.train()
        inputs, targets = _place(self.batch_processor(batch), self.device)
        with dist.data_parallel_step(self.mesh is not None):
            outputs = _cast_floats(self._forward(inputs), torch.float32)
            losses = self.criterion(outputs, targets, self.global_step)
            total = _sum_losses(losses)
            total.backward()
        self.optimizer.step()
        self.global_step += 1
        out = {k: v.detach() for k, v in losses.items()}
        out["total_loss"] = total.detach()
        return ranks_mean(out) if self.mesh is not None else out

    @torch.no_grad()
    def validation_step(self, batch) -> tp.Dict[str, float]:
        self.model.train()  # the training call, as the JAX trainer validates
        inputs, targets = _place(self.batch_processor(batch), self.device)
        with dist.data_parallel_step(self.mesh is not None):
            losses = self.criterion(self._forward(inputs), targets, self.global_step)
        losses = dict(losses, total_loss=_sum_losses(losses))
        if self.mesh is not None:
            losses = ranks_mean(losses)
        return {k: float(v) for k, v in losses.items()}

    # -- loop -------------------------------------------------------------------

    def fit(self, train_loader, val_loader=None,
            callbacks: tp.Sequence[tp.Callable] = ()) -> tp.Dict[str, float]:
        """Train to ``max_steps``; callbacks get ``(trainer, last)`` after each
        step. Returns the last step's losses as floats."""
        get_next = batch_getter(train_loader)
        last: dict = {}
        t0 = time.time()
        while self.global_step < self.cfg.max_steps:
            last = self.training_step(get_next())
            s = self.global_step
            if s % self.cfg.log_every == 0:
                LOGGER.info("step %d: %s (%.2f it/s)", s,
                            {k: round(float(v), 4) for k, v in last.items()},
                            s / max(time.time() - t0, 1e-9))
                self._log_tb("train", last, s)
            if val_loader is not None and s % self.cfg.val_every == 0:
                self._log_tb("val", self.validate(val_loader), s)
            if self.saver is not None and s % self.cfg.ckpt_every == 0:
                self.save_checkpoint()
            for cb in callbacks:
                cb(self, last)
        if self.saver is not None:
            self.save_checkpoint()
        return {k: float(v) for k, v in last.items()}

    def validate(self, val_loader) -> tp.Dict[str, float]:
        get_next = batch_getter(val_loader)
        metrics: tp.Dict[str, list] = {}
        for _ in range(self.cfg.val_batches):
            try:
                m = self.validation_step(get_next())
            except StopIteration:
                break  # an exhausted val loader ends validation, not training
            for k, v in m.items():
                metrics.setdefault(k, []).append(v)
        return {k: float(np.mean(v)) for k, v in metrics.items()}

    def _log_tb(self, prefix: str, metrics: tp.Mapping, step: int) -> None:
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)

    # -- persistence ------------------------------------------------------------

    def save_checkpoint(self, extra: tp.Optional[dict] = None) -> tp.Optional[Path]:
        """Rank 0 writes (the ranks' states are equal)."""
        if self.saver is None or dist.process_index() != 0:
            return None
        return self.saver.save(self.global_step, nnx_from_module(self.model),
                               self.optimizer.state_dict(), extra=extra)

    def load_checkpoint(self, path: tp.Union[str, Path]) -> dict:
        tree, payload = ExperimentSaver.load_checkpoint(ExperimentSaver.resumable(path))
        load_nnx_state(self.model, tree["model"])
        if tree.get("opt") is not None:
            self.optimizer.load_state_dict(tree["opt"])
        self.global_step = int(tree.get("step", 0))
        return payload
