"""Loss base with an iteration schedule (counterpart of
``speechflow_tpu/training/losses/base.py``): a loss is on from ``begin_iter``
until ``end_iter``, every ``every_iter`` steps, at ``scale`` (ramped linearly
over ``anneal_iters`` from ``begin_iter``)."""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

__all__ = ["LossSchedule", "BaseLoss"]


@dataclasses.dataclass
class LossSchedule:
    scale: float = 1.0
    begin_iter: int = 0
    end_iter: tp.Optional[int] = None
    every_iter: int = 1
    anneal_iters: int = 0  # linear ramp from begin_iter

    def gate(self, step: int) -> float:
        """The factor at global step ``step``: 0 when off, else the scale."""
        step = int(step)
        on = step >= self.begin_iter
        if self.end_iter is not None:
            on = on and step < self.end_iter
        if self.every_iter > 1:
            on = on and step % self.every_iter == 0
        scale = float(self.scale)
        if self.anneal_iters > 0:
            scale *= min(max((step - self.begin_iter) / self.anneal_iters, 0.0), 1.0)
        return scale if on else 0.0


class BaseLoss:
    def __init__(self, name: str = "", schedule: tp.Optional[LossSchedule] = None, **kwargs):
        self.name = name or type(self).__name__
        self.schedule = schedule or LossSchedule(**{
            k: v for k, v in kwargs.items()
            if k in ("scale", "begin_iter", "end_iter", "every_iter", "anneal_iters")})

    def compute(self, output, target, **kwargs) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, output, target=None, step: tp.Optional[int] = None,
                 **kwargs) -> torch.Tensor:
        val = self.compute(output, target, **kwargs)
        if step is None:
            return val * self.schedule.scale
        return val * self.schedule.gate(step)
