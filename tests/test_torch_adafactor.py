"""The port's adafactor (``training.optimizer.Adafactor`` inside the port's
``Optimizer``) against ``optax.adafactor(schedule)`` inside the JAX package's
chain, on the CPU in f32.

The module has the leaves where the two layouts part: a square Linear (torch's
(out, in) against flax's (in, out): the factored axes tie at 128), a
(K, C, C) conv, an attention block of one head of 128 (flax's (in, H, dh) kernel
is the port's (H·dh, in) weight: the factored axes are ``in`` and ``dh``), a
Linear with one side under 128 (not factored), biases, and a zero-initialised
Linear (its parameter scale is optax's floor of 1e-3, or it never moves).

Tolerance: ``TOL`` of a tensor's largest magnitude for the parameters, their
updates and the factored second moments (f32; the two sides sum the means in
other orders). The learning rate is large (0.5) so that an update is far above
the rounding of the parameter it is taken from.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from flax import nnx

from speechflow_torch.convert import (
    flatten_nnx,
    jax_layouts,
    load_nnx_state,
    nnx_from_module,
    state_dict_from_nnx,
)
from speechflow_torch.models.layers import Conv1d, MultiHeadAttention
from speechflow_torch.training.optimizer import (
    Adafactor,
    OptimizerConfig,
    ParamGroup,
    build_optimizer,
    factored_dims,
)

torch.set_num_threads(1)
TOL = 1e-6
C = 128


class JNet(nnx.Module):
    def __init__(self, rngs):
        self.square = nnx.Linear(C, C, rngs=rngs)
        self.conv = nnx.Conv(C, C, (3,), rngs=rngs)
        self.attn = nnx.MultiHeadAttention(num_heads=1, in_features=C, qkv_features=C,
                                           decode=False, rngs=rngs)
        self.narrow = nnx.Linear(C, 8, rngs=rngs)
        self.zero = nnx.Linear(C, 2 * C, kernel_init=nnx.initializers.zeros_init(), rngs=rngs)


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.square = nn.Linear(C, C)
        self.conv = Conv1d(C, C, 3)
        self.attn = MultiHeadAttention(C, 1)
        self.narrow = nn.Linear(C, 8)
        self.zero = nn.Linear(C, 2 * C)


def _pair():
    jm = JNet(nnx.Rngs(0))
    tm = load_nnx_state(Net(), nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
    return jm, tm


def _grads(jm, n: int, nan_at=()):
    rng = np.random.default_rng(1)
    shapes = flatten_nnx(nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
    out = []
    for i in range(n):
        g = {k: (3.0 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in shapes.items()}
        if i in nan_at:
            g = {k: np.full_like(v, np.nan) for k, v in g.items()}
        out.append(g)
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        node = out
        keys = [int(p) if p.isdigit() else p for p in k.split(".")]
        for p in keys[:-1]:
            node = node.setdefault(p, {})
        node[keys[-1]] = v
    return out


def _factored_state(tree: dict, cfg: OptimizerConfig) -> dict:
    """JAX's FactoredState node of the chain ``training.optimizer`` builds."""
    node = tree["opt_state"]
    if cfg.grad_accum > 1:
        node = node["inner_opt_state"]
    node = node["inner_state"]
    if cfg.grad_clip:
        node = node[1]
    if cfg.param_groups:
        node = node[0]
    return node[0]


def _worst(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _run(cfg: OptimizerConfig, n_micro: int, nan_at=()):
    """Both chains over the same gradients; yields, each micro-step, the worst
    relative error of the parameters, their updates and the second moments."""
    from speechflow_tpu.training.optimizer import OptimizerConfig as JCfg
    from speechflow_tpu.training.optimizer import ParamGroup as JGroup
    from speechflow_tpu.training.optimizer import build_optimizer as jbuild

    jm, tm = _pair()
    jcfg = JCfg(**{k: v for k, v in vars(cfg).items() if k != "param_groups"},
                param_groups=[JGroup(**vars(g)) for g in cfg.param_groups])
    jopt = nnx.Optimizer(jm, jbuild(jcfg, nnx.state(jm, nnx.Param)), wrt=nnx.Param)
    opt = build_optimizer(cfg, tm)
    assert isinstance(opt.base, Adafactor)
    layouts = jax_layouts(tm)
    for g in _grads(jm, n_micro, nan_at):
        before_t = flatten_nnx(nnx_from_module(tm))
        before_j = flatten_nnx(nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
        grads = nnx.state(jm, nnx.Param)
        nnx.replace_by_pure_dict(grads, jax.tree.map(jnp.asarray, _nest(g)))
        jopt.update(jm, grads)
        sd = state_dict_from_nnx(tm, _nest(g))
        for name, p in tm.named_parameters():
            p.grad = sd[name].clone()
        opt.step()
        after_t = flatten_nnx(nnx_from_module(tm))
        after_j = flatten_nnx(nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
        worst = {"param": 0.0, "update": 0.0, "state": 0.0}
        for k in after_j:
            worst["param"] = max(worst["param"], _worst(after_t[k], after_j[k]))
            du_t = after_t[k].astype(np.float64) - before_t[k]
            du_j = after_j[k].astype(np.float64) - before_j[k]
            if np.abs(du_j).max() > 0:
                worst["update"] = max(worst["update"], _worst(du_t, du_j))
            else:
                assert np.abs(du_t).max() == 0, k
        fs = _factored_state(nnx.to_pure_dict(nnx.state(jopt, nnx.Not(nnx.RngState))), cfg)
        flat = {e: flatten_nnx(fs[e]) for e in ("v_row", "v_col", "v")}
        for name, p in tm.named_parameters():
            st = opt.base.state.get(p) or {e: torch.zeros(shape) for e, shape
                                            in opt.base.state_shapes(p).items()}
            src = layouts[name][0]
            for e in ("v_row", "v_col", "v"):
                if e in st:
                    assert st[e].shape == flat[e][src].shape, (name, e)
                    if np.abs(flat[e][src]).max() > 0:
                        worst["state"] = max(worst["state"],
                                             _worst(st[e].numpy(), flat[e][src]))
                    else:
                        assert not st[e].any(), (name, e)
                else:
                    assert flat[e][src].shape == (1,), (name, e)
        yield worst, opt, jopt


SCHED = dict(lr=0.5, lr_schedule="WarmupCosine",
             lr_schedule_kwargs={"warmup_steps": 2, "decay_steps": 10})


def test_factored_axes_follow_the_jax_layout():
    """optax factors the two largest axes of the JAX shape, ties in argsort's
    order; the port's state has those shapes (the first step fills them)."""
    assert factored_dims((C, C)) == (0, 1)
    assert factored_dims((3, C, C)) == (1, 2)
    assert factored_dims((C, 1, C)) == (0, 2)
    assert factored_dims((C, 8)) is None and factored_dims((C,)) is None
    _, tm = _pair()
    opt = build_optimizer(OptimizerConfig(method="adafactor"), tm)
    shapes = {n: opt.base.state_shapes(p) for n, p in tm.named_parameters()}
    assert shapes["square.weight"] == {"v_row": (C,), "v_col": (C,)}
    assert shapes["conv.weight"] == {"v_row": (3, C), "v_col": (3, C)}
    assert shapes["attn.query.weight"] == {"v_row": (C, 1), "v_col": (1, C)}
    assert shapes["attn.out.weight"] == {"v_row": (1, C), "v_col": (1, C)}
    assert shapes["narrow.weight"] == {"v": (C, 8)}
    assert shapes["zero.bias"] == {"v": (2 * C,)}


def test_adafactor_steps_as_optax_through_the_recipe_chain():
    """Clip, ``MultiSteps`` at 2, a parameter-group window, and a NaN micro-batch
    (in the last optimizer step: optax's accumulator keeps it, ROADMAP §3): the
    five applied steps agree, the zero-initialised Linear moves from the second
    (the first is at the warmup's lr of 0), the window's leaf only inside it."""
    cfg = OptimizerConfig(method="adafactor", grad_clip=1.0, grad_accum=2,
                          param_groups=[ParamGroup(pattern="narrow", lr_scale=0.5,
                                                   begin_iter=2, end_iter=4)], **SCHED)
    zero_moved, narrow_moved = [], []
    prev = None
    for i, (worst, opt, _) in enumerate(_run(cfg, 12, nan_at=(11,))):
        assert worst["param"] <= TOL and worst["update"] <= TOL and worst["state"] <= TOL, \
            (i, worst)
        now = {n: p.detach().clone() for n, p in opt.module.named_parameters()}
        if prev is not None and i % 2 == 1:
            zero_moved.append(not torch.equal(now["zero.weight"], prev["zero.weight"]))
            narrow_moved.append(not torch.equal(now["narrow.weight"], prev["narrow.weight"]))
        prev = now
    assert opt.count == 5
    assert zero_moved == [False, True, True, True, True, False]  # the NaN step dropped
    assert narrow_moved == [False, False, True, True, False, False]


@pytest.mark.parametrize("case", ["plain", "clip_only"])
def test_adafactor_ignores_betas_eps_and_decay(case):
    """The config's betas, eps and weight decay change nothing, as in JAX."""
    cfgs = [OptimizerConfig(method="adafactor", grad_clip=None if case == "plain" else 1.0,
                            **SCHED),
            OptimizerConfig(method="adafactor", grad_clip=None if case == "plain" else 1.0,
                            betas=(0.5, 0.5), eps=1.0, weight_decay=0.3, **SCHED)]
    runs = []
    for cfg in cfgs:
        for worst, opt, _ in _run(cfg, 3):
            assert max(worst.values()) <= TOL, worst
        runs.append(flatten_nnx(nnx_from_module(opt.module)))
    assert all(np.array_equal(runs[0][k], runs[1][k]) for k in runs[0])


@pytest.mark.parametrize("accum", [1, 2])
def test_adafactor_state_resumes_from_a_jax_tree(accum):
    """A JAX chain's state after 3 micro-steps mapped onto a fresh port optimizer
    (``load_state_dict``): the next steps agree with JAX's."""
    cfg = OptimizerConfig(method="adafactor", grad_clip=1.0, grad_accum=accum, **SCHED)
    run = _run(cfg, 3)
    for _, opt, jopt in run:
        pass
    tree = nnx.to_pure_dict(nnx.state(jopt, nnx.Not(nnx.RngState)))
    fresh = build_optimizer(cfg, opt.module)
    fresh.load_state_dict(tree)
    assert fresh.count == opt.count and fresh.mini_step == opt.mini_step
    for p, q in zip(fresh.params, opt.params):
        a, b = fresh.base.state[p], opt.base.state[q]
        assert set(a) == set(b) and a["step"] == b["step"]
        for k in a:
            if k != "step":
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=TOL, atol=0)


def test_a_transposed_factored_entry_raises_by_name():
    """A ``v_row`` that does not have optax's shape for its parameter raises,
    naming it: the port never loads a moment onto the other axis."""
    cfg = OptimizerConfig(method="adafactor", grad_clip=None, **SCHED)
    for _, opt, jopt in _run(cfg, 1):
        pass
    tree = nnx.to_pure_dict(nnx.state(jopt, nnx.Not(nnx.RngState)))
    fs = tree["opt_state"]["inner_state"][0]
    saved = fs["v_row"]["conv"]["kernel"]
    fs["v_row"]["conv"]["kernel"] = np.zeros((C, 3), np.float32)
    with pytest.raises(ValueError, match="v_row"):
        build_optimizer(cfg, opt.module).load_state_dict(tree)
    fs["v_row"]["conv"]["kernel"] = saved
    del fs["v"]["narrow"]["kernel"]
    with pytest.raises(KeyError, match="narrow/kernel"):
        build_optimizer(cfg, opt.module).load_state_dict(tree)


def test_committed_jax_adafactor_run_resumes_as_jax_steps():
    """The committed JAX run (``tests/data/jax_checkpoints/resume_adafactor``: the debug
    ``tts_forward.yml`` at width 128 with ``method: adafactor``) resumed as ``-r``
    resumes it, one step on the recorded batch, through the card's check
    (``chip_smoke.adafactor_resume_step``) here on the CPU: losses, sampled parameters
    and sampled ``v_row`` / ``v_col`` / ``v`` against JAX's next step; and the planted
    fault (factored axes from the torch shape) rejected on the tied conv."""
    import chip_smoke

    res = chip_smoke.adafactor_resume_step(torch, "cpu")
    assert res["step0"] == res["count0"] == 2 and res["counts"] == (3, 3)
    assert res["factored"] == 4 and set(res["worst"]) == {"param", "v_row", "v_col", "v"}
    assert res["loss_err"] <= chip_smoke.TOL_F32_REL
    assert all(share <= 1 for share, _ in res["worst"].values()), res["worst"]
    bad = chip_smoke.adafactor_resume_step(torch, "cpu", fault=True)
    assert max(share for share, _ in bad["worst"].values()) > 1
    assert bad["worst"]["v_row"][1] == "postnet.blocks.1.conv.kernel"


def test_the_ports_own_adafactor_state_round_trips():
    """``state_dict`` / ``load_state_dict`` in the port's format (``opt.pt``): the next
    steps of a restored optimizer equal the original's."""
    cfg = OptimizerConfig(method="adafactor", grad_clip=1.0, grad_accum=2, **SCHED)
    _, tm = _pair()
    _, twin = _pair()
    opt = build_optimizer(cfg, tm)
    rng = np.random.default_rng(0)
    grads = [[torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
              for p in tm.parameters()] for _ in range(7)]
    for g in grads[:3]:
        for p, x in zip(tm.parameters(), g):
            p.grad = x.clone()
        opt.step()
    twin.load_state_dict(tm.state_dict())
    restored = build_optimizer(cfg, twin)
    blob = io.BytesIO()
    torch.save(opt.state_dict(), blob)  # as the saver writes opt.pt
    blob.seek(0)
    restored.load_state_dict(torch.load(blob, weights_only=False))
    assert restored.count == opt.count == 1 and restored.mini_step == opt.mini_step == 1
    for g in grads[3:]:
        for model, o in ((tm, opt), (twin, restored)):
            for p, x in zip(model.parameters(), g):
                p.grad = x.clone()
            o.step()
    assert all(torch.equal(a, b) for a, b in zip(tm.parameters(), twin.parameters()))
