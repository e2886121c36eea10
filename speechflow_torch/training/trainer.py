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
(``_cast_floats``). The JAX trainer's ``use_mesh`` (data parallel over a
device mesh) waits for DDP in the port and raises.
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
from speechflow_torch.training.optimizer import OptimizerConfig, build_optimizer
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
    use_mesh: bool = False        # data parallel: not ported (DDP is queued)
    mixed_precision: bool = False  # bf16 compute with fp32 master weights
    seed: int = 0


def _cast_floats(tree, dtype: torch.dtype):
    """Cast every floating tensor of a nested dict/list/tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
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
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
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
    """A TensorBoard writer for ``tb_dir`` (None for None); raises ImportError
    where the machine has no TensorBoard rather than skip the logging."""
    if tb_dir is None:
        return None
    from torch.utils.tensorboard import SummaryWriter

    return SummaryWriter(str(tb_dir))


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
        if self.cfg.use_mesh:
            raise NotImplementedError("use_mesh: data parallel training (DDP) is not "
                                      "ported yet")
        self.opt_cfg = optimizer_config or OptimizerConfig()
        self.saver = saver
        self.global_step = 0
        self.optimizer = build_optimizer(self.opt_cfg, model)
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
        outputs = _cast_floats(self._forward(inputs), torch.float32)
        losses = self.criterion(outputs, targets, self.global_step)
        total = _sum_losses(losses)
        total.backward()
        self.optimizer.step()
        self.global_step += 1
        out = {k: v.detach() for k, v in losses.items()}
        out["total_loss"] = total.detach()
        return out

    @torch.no_grad()
    def validation_step(self, batch) -> tp.Dict[str, float]:
        self.model.train()  # the training call, as the JAX trainer validates
        inputs, targets = _place(self.batch_processor(batch), self.device)
        losses = self.criterion(self._forward(inputs), targets, self.global_step)
        out = {k: float(v) for k, v in losses.items()}
        out["total_loss"] = float(_sum_losses(losses))
        return out

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
        if self.saver is None:
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
