"""The port's schedules and optimizer chain against the JAX package's optax
ones: the learning rate at every count, and the parameters after each of
several steps fed the same gradients (clip, a non-finite step that must
change nothing, grad accumulation, a parameter-group window, each method)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechflow_torch.training.lr_schedulers import build_lr_schedule
from speechflow_torch.training.optimizer import OptimizerConfig, ParamGroup, build_optimizer

torch.set_num_threads(1)
TOL = 1e-6  # f32 parameters of magnitude ~1: the two sides round the update differently


@pytest.mark.parametrize("name,kwargs", [
    ("ConstLR", {}),
    ("WarmupInvRsqrtLR", {"warmup_steps": 4}),
    ("WarmupCosine", {"warmup_steps": 3, "decay_steps": 12}),
    ("WarmupCosine", {"warmup_steps": 0, "decay_steps": 5, "end_lr_ratio": 0.1}),
])
def test_schedules_match_optax(name, kwargs):
    from speechflow_tpu.training.lr_schedulers import build_lr_schedule as jax_schedule

    ours, ref = build_lr_schedule(name, 2e-3, **kwargs), jax_schedule(name, 2e-3, **kwargs)
    for count in range(16):
        np.testing.assert_allclose(ours(count), float(ref(jnp.asarray(count))), rtol=1e-6,
                                   atol=1e-12)


class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.l1 = torch.nn.Linear(4, 3)
        self.l2 = torch.nn.Linear(3, 2)


def _to_jax_layout(name: str, a: np.ndarray) -> np.ndarray:
    return a.T if name.endswith("weight") else a


def _jax_key(name: str):
    mod, leaf = name.split(".")
    return mod, "kernel" if leaf == "weight" else "bias"


def _run(cfg: OptimizerConfig, grads: list, nan_at=()):
    """Both chains from the same parameters over ``grads`` (JAX layout); returns the
    parameters after every micro-step, (port, JAX)."""
    from speechflow_tpu.training.optimizer import build_optimizer as jax_build

    rng = np.random.default_rng(0)
    model = Tiny()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.uniform(-1, 1, p.shape).astype(np.float32)))
    names = [n for n, _ in model.named_parameters()]
    params = {}
    for name, p in model.named_parameters():
        mod, leaf = _jax_key(name)
        params.setdefault(mod, {})[leaf] = jnp.asarray(_to_jax_layout(name, p.detach().numpy()))
    opt = build_optimizer(cfg, model)
    tx = jax_build(cfg, params)
    state = tx.init(params)
    ours, ref = [], []
    for i, g in enumerate(grads):
        if i in nan_at:
            g = {k: {kk: np.full_like(vv, np.nan) for kk, vv in v.items()} for k, v in g.items()}
        for name, p in model.named_parameters():
            mod, leaf = _jax_key(name)
            p.grad = torch.from_numpy(np.ascontiguousarray(_to_jax_layout(name, g[mod][leaf])))
        opt.step()
        jg = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in g.items()}
        updates, state = tx.update(jg, state, params)
        params = optax.apply_updates(params, updates)
        ours.append({n: _to_jax_layout(n, p.detach().numpy().copy())
                     for n, p in model.named_parameters()})
        ref.append({n: np.asarray(params[_jax_key(n)[0]][_jax_key(n)[1]]) for n in names})
    return ours, ref


def _grads(n_steps: int, scale: float = 1.0):
    rng = np.random.default_rng(1)
    shapes = {"l1": {"kernel": (4, 3), "bias": (3,)}, "l2": {"kernel": (3, 2), "bias": (2,)}}
    return [{m: {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in d.items()}
             for m, d in shapes.items()} for _ in range(n_steps)]


SCHED = dict(lr_schedule="WarmupCosine", lr_schedule_kwargs={"warmup_steps": 2,
                                                             "decay_steps": 10})


@pytest.mark.parametrize("case", ["adamw_clip", "nan_step", "accum4", "window", "adam", "sgd",
                                  "lamb"])
def test_optimizer_matches_the_optax_chain(case):
    cfg = dict(method="adamw", lr=1e-2, weight_decay=0.01, grad_clip=1.0, **SCHED)
    grads, nan_at = _grads(6, scale=3.0), ()  # global norm ~10: every step clips
    if case == "nan_step":
        nan_at = (2,)
    elif case == "accum4":
        cfg["grad_accum"], grads, nan_at = 4, _grads(12, scale=3.0), (9,)
    elif case == "window":
        cfg["param_groups"] = [ParamGroup(pattern="l2/kernel", lr_scale=0.5, begin_iter=2,
                                          end_iter=4)]
    elif case in ("adam", "sgd", "lamb"):
        cfg.update(method=case, grad_clip=None)
    ours, ref = _run(OptimizerConfig(**cfg), grads, nan_at)
    for i, (a, b) in enumerate(zip(ours, ref)):
        for name in a:
            np.testing.assert_allclose(a[name], b[name], atol=TOL, rtol=0,
                                       err_msg=f"{case}: {name} after micro-step {i}")
    if case == "nan_step":  # the non-finite step changed nothing
        assert all(np.array_equal(ours[2][k], ours[1][k]) for k in ours[1])
    if case == "accum4":
        # steps at the 4th, 8th and 12th micro-step: the first at the schedule's lr of 0
        # (count 0), the third's average holds the NaN and is dropped
        moved = [not all(np.array_equal(ours[i][k], ours[i - 1][k]) for k in ours[i])
                 for i in range(1, 12)]
        assert moved == [i == 7 for i in range(1, 12)]
    if case == "window":  # l2's kernel moves in [2, 4) only, at half the step
        moved = [not np.array_equal(ours[i]["l2.weight"], ours[i - 1]["l2.weight"])
                 for i in range(1, 6)]
        assert moved == [False, True, True, False, False]


def test_adafactor_raises_until_ported():
    """adafactor is ported (``tests/test_torch_adafactor.py`` holds it against
    optax): it builds the port's ``Adafactor``, not torch's, which factors other
    axes; an unknown method still raises."""
    from speechflow_torch.training.optimizer import Adafactor

    opt = build_optimizer(OptimizerConfig(method="adafactor"), Tiny())
    assert type(opt.base) is Adafactor
    with pytest.raises(ValueError, match="unknown optimizer method"):
        build_optimizer(OptimizerConfig(method="adagrad"), Tiny())
