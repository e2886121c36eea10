"""Learning-rate schedules (counterpart of
``speechflow_tpu/training/lr_schedulers.py``): ConstLR, WarmupInvRsqrtLR and
WarmupCosine, each a function of the optimizer's update count (from 0) giving
the value the JAX package's optax schedule gives at that count
(``WarmupCosine`` is ``optax.warmup_cosine_decay_schedule`` from 0 to ``lr``
and down to ``lr · end_lr_ratio``)."""

from __future__ import annotations

import math
import typing as tp

from speechflow_torch.utils.init import filter_kwargs

__all__ = ["build_lr_schedule", "SCHEDULES"]

Schedule = tp.Callable[[int], float]


def const_lr(lr: float) -> Schedule:
    return lambda count: lr


def warmup_invrsqrt(lr: float, warmup_steps: int = 4000) -> Schedule:
    def schedule(count: int) -> float:
        step = max(count, 1)
        return lr * min(step / warmup_steps, (warmup_steps / step) ** 0.5)

    return schedule


def warmup_cosine(lr: float, warmup_steps: int = 1000, decay_steps: int = 1_000_000,
                  end_lr_ratio: float = 0.01) -> Schedule:
    alpha = 0.0 if lr == 0.0 else (lr * end_lr_ratio) / lr
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:  # optax.linear_schedule(0, lr, warmup_steps)
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (0.0 - lr) * frac + lr
        c = min(count - warmup_steps, cos_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return lr * ((1.0 - alpha) * decay + alpha)

    return schedule


SCHEDULES: tp.Dict[str, tp.Callable[..., Schedule]] = {
    "ConstLR": const_lr,
    "WarmupInvRsqrtLR": warmup_invrsqrt,
    "WarmupCosine": warmup_cosine,
}


def build_lr_schedule(name: str = "ConstLR", lr: float = 1e-4, **kwargs) -> Schedule:
    fn = SCHEDULES[name]
    return fn(lr=lr, **filter_kwargs(fn, kwargs))
