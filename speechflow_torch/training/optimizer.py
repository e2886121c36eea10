"""The optimizer of the trainers (counterpart of
``speechflow_tpu/training/optimizer.py``).

The JAX package builds the optax chain

    MultiSteps(apply_if_finite(clip_by_global_norm -> base -> windows), k)

and ``build_optimizer`` gives the same semantics over ``torch.optim``:

- ``MultiSteps``: the k micro-batch gradients are averaged (optax's running
  mean, ``acc += (g - acc) / (n + 1)``); the rest of the chain runs once per k,
  and the parameters do not move in between.
- ``apply_if_finite``: an optimizer step whose (averaged) gradient is not
  finite is dropped whole, moments and counts untouched; after more than 100
  such steps in a row it is applied anyway.
- ``clip_by_global_norm``: the gradient is scaled by max/norm when its global
  norm is not below max.
- the base step: ``adamw`` (decoupled decay: ``-lr·(adam + wd·p)``), ``adam``,
  ``sgd`` (momentum = betas[0]), ``lamb`` (torch has no LAMB: ``Lamb`` below)
  or ``adafactor`` (``optax.adafactor(schedule)``: ``Adafactor`` below, not
  torch's, which factors other axes; the config's betas, eps and weight decay
  are ignored, as the JAX package ignores them).
- the schedule is read at the count of applied steps, from 0;
- parameter-group windows gate the *updates*: a parameter whose path in the
  JAX layout (``convert.nnx_path``) contains a group's pattern (first match
  wins) moves by ``lr_scale`` times the update inside [begin_iter, end_iter)
  and not at all outside it, weight decay included. Here that is the torch
  param group's learning rate: schedule × scale × window.

``step()`` is called after each micro-batch's backward: it takes the
parameters' ``.grad`` and clears them. ``load_state_dict`` takes the port's
``state_dict()`` or the optimizer tree of a JAX checkpoint (optax's state,
mapped by ``training.optax_state``).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch
import torch.nn as nn

from speechflow_torch.convert import jax_layouts, nnx_path
from speechflow_torch.training.lr_schedulers import build_lr_schedule
from speechflow_torch.training.optax_state import is_optax_state, load_optax_state
from speechflow_torch.utils.profiler import span

__all__ = ["OptimizerConfig", "ParamGroup", "Lamb", "Adafactor", "factored_dims", "Optimizer",
           "build_optimizer", "optax_optimizer"]

MAX_CONSECUTIVE_ERRORS = 100
OPTAX_ADAMW_DECAY = 1e-4  # optax.adamw's default weight decay (torch's AdamW: 1e-2)


@dataclasses.dataclass
class ParamGroup:
    pattern: str                      # substring of the parameter's JAX path
    lr_scale: float = 1.0
    begin_iter: int = 0
    end_iter: tp.Optional[int] = None  # None = forever


@dataclasses.dataclass
class OptimizerConfig:
    method: str = "adamw"             # adam | adamw | sgd | lamb | adafactor
    lr: float = 1e-4
    lr_schedule: str = "ConstLR"
    lr_schedule_kwargs: tp.Dict[str, tp.Any] = dataclasses.field(default_factory=dict)
    weight_decay: float = 1e-6
    betas: tp.Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    grad_clip: tp.Optional[float] = 1.0
    grad_accum: int = 1               # micro-batches per optimizer step
    param_groups: tp.List[ParamGroup] = dataclasses.field(default_factory=list)

    @staticmethod
    def from_config(cfg: tp.Mapping) -> "OptimizerConfig":
        cfg = dict(cfg)
        groups = [ParamGroup(**g) for g in cfg.pop("param_groups", [])]
        known = {f.name for f in dataclasses.fields(OptimizerConfig)}
        return OptimizerConfig(**{k: v for k, v in cfg.items() if k in known},
                               param_groups=groups)


class Lamb(torch.optim.Optimizer):
    """optax.lamb: Adam's direction plus decoupled decay, scaled per parameter
    by the trust ratio ||p|| / ||update|| (1 where either norm is 0)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["step"] += 1
                g = p.grad
                st["mu"].mul_(b1).add_(g, alpha=1 - b1)
                st["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (st["mu"] / (1 - b1 ** st["step"])) / (
                    torch.sqrt(st["nu"] / (1 - b2 ** st["step"])) + group["eps"])
                u = u + group["weight_decay"] * p
                p_norm, u_norm = torch.linalg.norm(p), torch.linalg.norm(u)
                ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                    p_norm / u_norm)
                p.add_(u * ratio, alpha=-group["lr"])


def factored_dims(shape: tp.Sequence[int], min_dim_size_to_factor: int = 128
                  ) -> tp.Optional[tp.Tuple[int, int]]:
    """optax's ``_factored_dims``: the axes (second largest, largest) of ``shape``
    in ``np.argsort``'s order (ties by position), or None below 2 dims or when
    the second largest is under ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr)`` with its defaults: the chain
    ``scale_by_factored_rms`` (decay ``1 - (count+1)^-0.8``, eps 1e-30, factored
    over the two largest axes when both are at least 128) -> ``clip_by_block_rms(1)``
    -> ``lr`` -> ``scale_by_param_block_rms`` (at least 1e-3) -> ``-1``: no
    momentum, no weight decay.

    ``layouts`` maps a parameter to (to JAX's layout, back to the port's)
    (``convert.jax_layouts``): the factored axes are those of the parameter's
    shape in the JAX package, and the state (``v_row``, ``v_col`` of a factored
    parameter, ``v`` of another) is kept in that layout, as optax keeps it, so a
    square Linear or a (K, C, C) conv factors the axes JAX's does. Without one a
    parameter is taken in its own layout."""

    def __init__(self, params, lr: float = 1e-3, layouts: tp.Optional[tp.Mapping] = None):
        super().__init__(params, dict(lr=lr))
        self.layouts = dict(layouts or {})
        # optax.adafactor's defaults (per instance: a test may plant a fault in one)
        self.decay_rate, self.eps, self.min_dim_size_to_factor = 0.8, 1e-30, 128
        self.clipping_threshold, self.min_scale = 1.0, 1e-3

    def _layout(self, p):
        ident = (lambda a: a)
        return self.layouts.get(p, (ident, ident))

    def state_shapes(self, p: torch.Tensor) -> tp.Dict[str, tp.Tuple[int, ...]]:
        """The shapes of a parameter's state in JAX's layout: ``v_row`` and
        ``v_col`` (its shape without the largest, the second largest axis) where
        it is factored, else ``v``."""
        shape = tuple(self._layout(p)[0](p).shape)
        dims = factored_dims(shape, self.min_dim_size_to_factor)
        if dims is None:
            return {"v": shape}
        d1, d0 = dims
        return {"v_row": shape[:d0] + shape[d0 + 1:], "v_col": shape[:d1] + shape[d1 + 1:]}

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.sub_(self.update(p, p.grad, group["lr"]))

    @torch.no_grad()
    def update(self, p: torch.Tensor, grad: torch.Tensor, lr: float) -> torch.Tensor:
        """The step's change of ``p`` from ``grad`` (to subtract, in the port's
        layout); advances ``p``'s state."""
        st = self.state[p]
        if not st:
            st["step"] = 0
            st.update({k: p.new_zeros(shape) for k, shape in self.state_shapes(p).items()})
        to_jax, to_port = self._layout(p)
        g, w = to_jax(grad), to_jax(p)
        t = np.float32(st["step"] + 1)
        decay = float(np.float32(1.0) - t ** np.float32(-self.decay_rate))
        g2 = g * g + self.eps
        if "v" in st:
            st["v"].mul_(decay).add_(g2, alpha=1.0 - decay)
            u = g * st["v"].pow(-0.5)
        else:
            d1, d0 = factored_dims(tuple(g.shape), self.min_dim_size_to_factor)
            st["v_row"].mul_(decay).add_(g2.mean(d0), alpha=1.0 - decay)
            st["v_col"].mul_(decay).add_(g2.mean(d1), alpha=1.0 - decay)
            row = st["v_row"]
            row_factor = (row / row.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)).pow(-0.5)
            u = g * row_factor.unsqueeze(d0) * st["v_col"].pow(-0.5).unsqueeze(d1)
        u = u / torch.clamp(u.pow(2).mean().sqrt() / self.clipping_threshold, min=1.0)
        rms = w.pow(2).mean().sqrt()
        u = u * torch.where(rms <= self.min_scale, torch.full_like(rms, self.min_scale), rms)
        st["step"] += 1
        return to_port(u * lr)


def _base(cfg: OptimizerConfig, groups: list, module: nn.Module) -> torch.optim.Optimizer:
    b1, b2 = cfg.betas
    if cfg.method == "adamw":
        return torch.optim.AdamW(groups, lr=cfg.lr, betas=(b1, b2), eps=cfg.eps,
                                 weight_decay=cfg.weight_decay)
    if cfg.method == "adam":
        return torch.optim.Adam(groups, lr=cfg.lr, betas=(b1, b2), eps=cfg.eps)
    if cfg.method == "sgd":
        return torch.optim.SGD(groups, lr=cfg.lr, momentum=b1)
    if cfg.method == "lamb":
        return Lamb(groups, lr=cfg.lr, betas=(b1, b2), eps=cfg.eps,
                    weight_decay=cfg.weight_decay)
    if cfg.method == "adafactor":
        layouts = jax_layouts(module)
        return Adafactor(groups, lr=cfg.lr, layouts={p: layouts[name][1:] for name, p
                                                     in module.named_parameters()})
    raise ValueError(f"unknown optimizer method: {cfg.method}")


class Optimizer:
    """The JAX package's optax chain over a ``torch.optim`` optimizer; see the
    module docstring. ``count`` is the number of applied optimizer steps."""

    def __init__(self, cfg: OptimizerConfig, module: nn.Module):
        self.cfg = cfg
        self.schedule = build_lr_schedule(cfg.lr_schedule, cfg.lr, **cfg.lr_schedule_kwargs)
        self.module = module
        paths = nnx_path(module)
        by_group: tp.Dict[tp.Optional[int], list] = {}
        for name, p in module.named_parameters():
            if p.requires_grad:
                g = next((i for i, pg in enumerate(cfg.param_groups)
                          if pg.pattern in paths[name]), None)
                by_group.setdefault(g, []).append((name, p))
        self.names = [name for ps in by_group.values() for name, _ in ps]
        self.params = [p for ps in by_group.values() for _, p in ps]
        self.base = _base(cfg, [{"params": [p for _, p in ps], "sf_group": g}
                                for g, ps in by_group.items()], module)
        self.count = 0
        self.mini_step = 0
        self.notfinite_count = 0
        self.acc: tp.Optional[tp.List[torch.Tensor]] = None
        #: the optimizer step's gradients -> the gradients it applies: data-parallel
        #: trainers average them over the ranks here, once per optimizer step
        self.reduce_grads: tp.Optional[tp.Callable[[tp.List[torch.Tensor]],
                                                   tp.List[torch.Tensor]]] = None

    def _grads(self) -> tp.List[torch.Tensor]:
        return [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]

    def _gate(self, group: tp.Optional[int]) -> float:
        if group is None:
            return 1.0
        pg = self.cfg.param_groups[group]
        on = self.count >= pg.begin_iter and (pg.end_iter is None or self.count < pg.end_iter)
        return pg.lr_scale if on else 0.0

    @torch.no_grad()
    def step(self) -> bool:
        """Take this micro-batch's gradients; returns whether the parameters
        were updated."""
        with span("optim.step"):
            grads = self._grads()
            for p in self.params:
                p.grad = None
            k = self.cfg.grad_accum
            if k > 1:
                if self.acc is None:
                    self.acc = [torch.zeros_like(p) for p in self.params]
                n = self.mini_step
                for a, g in zip(self.acc, grads):
                    a.add_((g - a) / (n + 1))
                self.mini_step = (n + 1) % k
                if self.mini_step:
                    return False
                grads, self.acc = self.acc, None
            if self.reduce_grads is not None:
                grads = self.reduce_grads(grads)
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not (finite or self.notfinite_count > MAX_CONSECUTIVE_ERRORS):
                return False
            if self.cfg.grad_clip:
                norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
                if not bool(norm < self.cfg.grad_clip):
                    grads = [g / norm * self.cfg.grad_clip for g in grads]
            lr = self.schedule(self.count)
            for group in self.base.param_groups:
                group["lr"] = lr * self._gate(group["sf_group"])
            for p, g in zip(self.params, grads):
                p.grad = g
            self.base.step()
            for p in self.params:
                p.grad = None
            self.count += 1
            return True

    def state_dict(self) -> dict:
        return {"base": self.base.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "notfinite_count": self.notfinite_count,
                "acc": self.acc}

    def load_state_dict(self, state: tp.Mapping) -> None:
        if is_optax_state(state):
            load_optax_state(self, state)
            return
        self.base.load_state_dict(state["base"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self.notfinite_count = int(state["notfinite_count"])
        dev = self.params[0].device if self.params else None
        self.acc = None if state["acc"] is None else [a.to(dev) for a in state["acc"]]


def build_optimizer(cfg: OptimizerConfig, module: nn.Module) -> Optimizer:
    return Optimizer(cfg, module)


def optax_optimizer(params: tp.Iterable[torch.Tensor], method: str, lr: float,
                    weight_decay: float = OPTAX_ADAMW_DECAY,
                    capturable: bool = False) -> torch.optim.Optimizer:
    """A bare ``optax.adam(lr)`` or ``optax.adamw(lr, weight_decay)`` (optax's
    betas and eps, decay decoupled; no clipping, accumulation or finiteness gate)
    as torch's: the chain of the auxiliary models' trainers (G2P, CPC, CREPE,
    the examples). ``capturable`` lets a CUDA graph capture its step."""
    kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=capturable)
    if method == "adam":
        return torch.optim.Adam(params, **kw)
    if method == "adamw":
        return torch.optim.AdamW(params, weight_decay=weight_decay, **kw)
    raise ValueError(f"optax_optimizer: adam or adamw, not {method!r}")
