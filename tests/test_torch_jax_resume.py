"""Resuming a JAX checkpoint, optimizer state included, on the port (CPU, f32).

The JAX package's ``nnx.Optimizer`` state (optax's) is saved by its
``ExperimentSaver`` (orbax), read by the port's loader and mapped onto the port's
``Optimizer`` (``training.optax_state``); then both sides take the next step
from the same gradients and the parameters and moments agree:

- every method the port maps (adam, adamw, sgd, lamb), with and without
  accumulation (saved mid-accumulation), a parameter-group window that is on and
  one that is still off, weight decay, clipping, a non-finite step carried in
  ``notfinite_count``; a tree with a missing entry raises by name (adafactor:
  ``tests/test_torch_adafactor.py``);
- the generic ``Trainer`` resumed through ``resume.from`` (``-r``) from a JAX
  ``Trainer`` checkpoint saved mid-accumulation;
- the GAN trainer's pair of optimizers, from a JAX ``GANTrainer`` checkpoint;
- where the two chains part: after a non-finite micro-batch under accumulation
  optax's accumulator stays NaN (each later step is dropped), the port's starts
  afresh at the next step (ROADMAP §3).

Tolerance: ``TOL`` for parameters and moments of magnitude ~1 (the two sides
round each update differently, as in ``test_torch_optim``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.convert import flatten_nnx, load_nnx_state, nnx_from_module
from speechflow_torch.scripts.common import apply_resume_warmstart
from speechflow_torch.training.optimizer import OptimizerConfig, ParamGroup, build_optimizer
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)
TOL = 2e-6


class JTiny(nnx.Module):
    def __init__(self, rngs):
        self.a = nnx.Linear(4, 3, rngs=rngs)
        self.b = nnx.Linear(3, 2, rngs=rngs)


class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(4, 3)
        self.b = torch.nn.Linear(3, 2)


def _grads(rng, jm, nan: bool = False):
    """A gradient tree of the JAX model's shape (a NaN tree for ``nan``)."""
    state = nnx.state(jm, nnx.Param)
    return jax.tree.map(lambda p: jnp.full(p.shape, jnp.nan) if nan else
                        jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), state)


def _set_grads(module, grads) -> None:
    flat = flatten_nnx(nnx.to_pure_dict(grads))
    view = _pure_to_port(module, flat)
    for name, p in module.named_parameters():
        p.grad = view[name].clone()


def _pure_to_port(module, flat: dict) -> dict:
    from speechflow_torch.convert import state_dict_from_nnx

    nested: dict = {}
    for k, v in flat.items():
        node = nested
        parts = k.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return state_dict_from_nnx(module, nested)


def _moments(opt) -> dict:
    """The port optimizer's state as {port name: {key: numpy}}."""
    out = {}
    for name, p in zip(opt.names, opt.params):
        out[name] = {k: (v.detach().numpy().copy() if isinstance(v, torch.Tensor) else v)
                     for k, v in opt.base.state.get(p, {}).items()}
    return out


def _jax_moments(module, jopt, cfg) -> dict:
    """JAX's mu / nu (or trace) in the port's names and layout."""
    from speechflow_torch.training.optax_state import load_optax_state

    probe = build_optimizer(cfg, module)
    load_optax_state(probe, nnx.to_pure_dict(nnx.state(jopt, nnx.Not(nnx.RngState))))
    return _moments(probe), probe


METHODS = [
    ("adamw", 1, True), ("adamw", 2, True), ("adam", 2, False), ("sgd", 1, False),
    ("sgd", 2, True), ("lamb", 2, True),
]


@pytest.mark.parametrize("method,accum,groups", METHODS)
def test_optax_state_resumes_on_the_port(method, accum, groups, tmp_path):
    """JAX applies 5 micro-steps and saves (without accumulation the last one
    is NaN: ``notfinite_count`` 1 carries over; with it the save falls
    mid-accumulation); the port loads the checkpoint and both take step 6:
    parameters, moments, counts."""
    from speechflow_tpu.training.optimizer import OptimizerConfig as JCfg
    from speechflow_tpu.training.optimizer import ParamGroup as JGroup
    from speechflow_tpu.training.optimizer import build_optimizer as jbuild
    from speechflow_tpu.training.saver import ExperimentSaver as JSaver

    kw = dict(method=method, lr=0.05, lr_schedule="WarmupCosine",
              lr_schedule_kwargs={"warmup_steps": 2, "decay_steps": 20}, weight_decay=0.01,
              grad_clip=1.5, grad_accum=accum)
    windows = [("b/kernel", 0.5, 0, 10), ("a/bias", 1.0, 4, None)] if groups else []
    cfg = OptimizerConfig(**kw, param_groups=[ParamGroup(*w) for w in windows])
    jcfg = JCfg(**kw, param_groups=[JGroup(*w) for w in windows])
    rng = np.random.default_rng(0)
    jm = JTiny(nnx.Rngs(0))
    jopt = nnx.Optimizer(jm, jbuild(jcfg, nnx.state(jm, nnx.Param)), wrt=nnx.Param)
    nan_at = 4 if accum == 1 else None
    for i in range(5):
        jopt.update(jm, _grads(rng, jm, nan=i == nan_at))
    path = JSaver(tmp_path, "run").save(
        5, nnx.to_pure_dict(nnx.state(jm, nnx.Param)),
        opt_state=nnx.to_pure_dict(nnx.state(jopt, nnx.Not(nnx.RngState))))

    tree, _ = ExperimentSaver.load_checkpoint(ExperimentSaver.resumable(path))
    tm = Tiny()
    load_nnx_state(tm, tree["model"])
    opt = build_optimizer(cfg, tm)
    opt.load_state_dict(tree["opt"])
    applied = 4 if accum == 1 else 2  # the NaN step was dropped
    assert (opt.count, opt.mini_step) == (applied, 5 % accum)
    assert opt.notfinite_count == (1 if accum == 1 else 0)
    assert (opt.acc is not None) == (accum == 2)

    g = _grads(rng, jm)
    jopt.update(jm, g)
    _set_grads(tm, g)
    assert opt.step()
    ours = flatten_nnx(nnx_from_module(tm))
    ref = flatten_nnx(nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=TOL, err_msg=k)
    ref_m, probe = _jax_moments(Tiny(), jopt, cfg)
    got_m = _moments(opt)
    assert probe.count == opt.count == applied + 1 and probe.notfinite_count == 0
    for name in got_m:
        assert set(got_m[name]) == set(ref_m[name]), name
        for key, v in ref_m[name].items():
            np.testing.assert_allclose(np.asarray(got_m[name][key], np.float32),
                                       np.asarray(v, np.float32), atol=TOL,
                                       err_msg=f"{name}.{key}")


def test_unmapped_optax_trees_raise_by_name(tmp_path):
    from speechflow_tpu.training.optimizer import OptimizerConfig as JCfg
    from speechflow_tpu.training.optimizer import build_optimizer as jbuild

    jm = JTiny(nnx.Rngs(0))
    jopt = nnx.Optimizer(jm, jbuild(JCfg(method="adamw")), wrt=nnx.Param)
    tree = nnx.to_pure_dict(nnx.state(jopt, nnx.Not(nnx.RngState)))
    adafactor = build_optimizer(OptimizerConfig(method="adafactor"), Tiny())
    with pytest.raises(KeyError, match="inner_state/1/0/v_row"):  # an adamw tree
        adafactor.load_state_dict(tree)
    opt = build_optimizer(OptimizerConfig(method="adamw"), Tiny())
    del tree["opt_state"]["inner_state"][1][0]["mu"]["b"]["bias"]
    with pytest.raises(KeyError, match="b.bias"):
        opt.load_state_dict(tree)
    del tree["opt_state"]["inner_state"][1][0]["mu"]
    with pytest.raises(KeyError, match="inner_state/1/0/mu"):
        opt.load_state_dict(tree)
    with pytest.raises(KeyError, match="mini_step"):  # a config the tree was not built by
        build_optimizer(OptimizerConfig(method="adamw", grad_accum=2), Tiny()).load_state_dict(
            nnx.to_pure_dict(nnx.state(jopt, nnx.Not(nnx.RngState))))


def test_trainer_resumes_a_jax_trainer_with_r(tmp_path):
    """``resume.from`` (``-r``) of a JAX ``Trainer`` run saved mid-accumulation
    (AdamW with weight decay, a window): the port's next micro-batch completes
    the accumulation as JAX's does."""
    from speechflow_tpu.training import OptimizerConfig as JOpt
    from speechflow_tpu.training import Trainer as JTrainer
    from speechflow_tpu.training import TrainerConfig as JCfg
    from speechflow_tpu.training.saver import ExperimentSaver as JSaver
    from tests.test_torch_trainers import TinyModel
    from tests.test_training import TinyModel as JTinyModel
    from tests.torch_parity import randomize

    opt = dict(method="adamw", lr=1e-2, weight_decay=0.05, grad_accum=2,
               lr_schedule="WarmupCosine", lr_schedule_kwargs={"warmup_steps": 1,
                                                               "decay_steps": 10},
               param_groups=[{"pattern": "l2", "lr_scale": 0.5, "begin_iter": 0,
                              "end_iter": 5}])

    def jcrit(out, tgt, step):
        return {"mse": jnp.mean((out - tgt["y"]) ** 2)}

    def tcrit(out, tgt, step):
        return {"mse": torch.mean((out - tgt["y"]) ** 2)}

    def bp(batch):
        return {"x": batch["x"]}, {"y": batch["y"]}

    rng = np.random.default_rng(1)
    batches = []
    for i in range(6):
        x = rng.normal(size=(4, 8)).astype(np.float32)
        y = (x[:, :4] * 2.0).astype(np.float32)
        batches.append({"x": x, "y": y})
    jm = randomize(JTinyModel(rngs=nnx.Rngs(0)), seed=5)
    saver = JSaver(tmp_path, "run")
    jt = JTrainer(jm, jcrit, bp, JOpt.from_config(opt), JCfg(max_steps=10), saver=saver)
    for b in batches[:5]:
        jt.training_step(b)
    jt.save_checkpoint()

    tt = Trainer(TinyModel(), tcrit, bp, OptimizerConfig.from_config(opt),
                 TrainerConfig(max_steps=10))
    apply_resume_warmstart(tt, {"resume": {"from": str(saver.expr_path)}})
    assert tt.global_step == 5
    assert (tt.optimizer.count, tt.optimizer.mini_step) == (2, 1)
    jt.training_step(batches[5])
    tt.training_step(batches[5])
    ref = flatten_nnx(nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
    ours = flatten_nnx(nnx_from_module(tt.model))
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-5, err_msg=k)
    assert (tt.optimizer.count, tt.optimizer.mini_step) == (3, 0)


def test_gan_trainer_resumes_both_optimizers(tmp_path):
    """A JAX ``GANTrainer`` of the debug vocoder recipe takes 2 steps and saves;
    the port's GAN trainer resumes it: both optimizers' moments and counts are
    JAX's bit for bit, and the third step moves both models as JAX's does
    (within two Adam steps, the recipe's kinks; ``test_torch_trainers``)."""
    from speechflow_tpu.training.saver import ExperimentSaver as JSaver
    from speechflow_torch.scripts.train_vocoder import configs
    from tests.test_torch_trainers import _batches, _jax_weights, _pair, _steps, _weights
    from tests.test_torch_trainers import _within_adam_step

    opt_cfg = configs("debug")[0]["optimizer"]
    jax_gan, ours = _pair(opt_cfg)
    jax_gan.saver = JSaver(tmp_path, "gan")
    batches = _batches(3)
    for b in batches[:2]:
        jax_gan.training_step(b)
    path = jax_gan.save_checkpoint()
    _, fresh = _pair(opt_cfg)
    fresh.load_checkpoint(path)
    assert fresh.global_step == 2
    for opt, jopt in ((fresh.gen_opt, jax_gan.gen_opt), (fresh.disc_opt, jax_gan.disc_opt)):
        ref, probe = _jax_moments(opt.module, jopt, opt.cfg)
        assert opt.count == probe.count == 2
        got = _moments(opt)
        for name in ref:
            for key, v in ref[name].items():
                np.testing.assert_array_equal(np.asarray(got[name][key]), np.asarray(v),
                                              err_msg=f"{name}.{key}")
    _steps(jax_gan, fresh, batches[2:])
    for tag, tm, jm in (("generator", fresh.generator, jax_gan.generator),
                        ("discriminator", fresh.discriminator, jax_gan.discriminator)):
        _within_adam_step(_weights(tm), _jax_weights(jm), fresh.gen_opt.schedule(2), tag)


def test_a_checkpoint_without_optimizer_state_is_not_resumed(tmp_path):
    """Weights alone: resuming would restart the moments from zero, so it is
    refused (finetune or warm start take it)."""
    from speechflow_tpu.training.saver import ExperimentSaver as JSaver

    path = JSaver(tmp_path, "w").save(1, {"w": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="no optimizer state"):
        ExperimentSaver.resumable(path)


def test_a_nan_micro_batch_poisons_jax_accumulation_not_the_ports():
    """A fault of the reference the port does not copy: optax's ``MultiSteps``
    resets its accumulator by scaling it, so after one non-finite micro-batch
    (grad_accum 2) every later accumulation is NaN and dropped (after 100 in a
    row ``apply_if_finite`` would apply one); the port drops that step and
    accumulates afresh. A resumed JAX checkpoint carries the poisoned
    accumulator, and the port drops only the step it poisons."""
    from speechflow_tpu.training.optimizer import OptimizerConfig as JCfg
    from speechflow_tpu.training.optimizer import build_optimizer as jbuild

    rng = np.random.default_rng(3)
    jm = JTiny(nnx.Rngs(0))
    jopt = nnx.Optimizer(jm, jbuild(JCfg(method="adam", grad_accum=2)), wrt=nnx.Param)
    tm = Tiny()
    load_nnx_state(tm, nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
    opt = build_optimizer(OptimizerConfig(method="adam", grad_accum=2), tm)
    for i in range(3):  # NaN, finite: a dropped step; then one micro-batch
        g = _grads(rng, jm, nan=i == 0)
        jopt.update(jm, g)
        _set_grads(tm, g)
        opt.step()
    state = nnx.to_pure_dict(nnx.state(jopt, nnx.Not(nnx.RngState)))
    assert np.isnan(np.asarray(state["opt_state"]["acc_grads"]["a"]["bias"])).all()
    assert opt.acc is not None and all(torch.isfinite(a).all() for a in opt.acc)
    resumed = build_optimizer(OptimizerConfig(method="adam", grad_accum=2), Tiny())
    resumed.load_state_dict(state)
    g = _grads(rng, jm)
    _set_grads(resumed.module, g)
    assert not resumed.step() and resumed.notfinite_count == 2 and resumed.acc is None
    _set_grads(tm, g)
    assert opt.step() and opt.count == 1


@pytest.mark.parametrize("kind", ["tts", "vocoder"])
def test_committed_jax_runs_resume_as_jax_steps(kind):
    """The committed JAX runs (``tests/data/jax_checkpoints/resume``: the debug
    ``tts_forward.yml`` and ``vocoder_model.yml`` recipes, narrowed, with optax
    state) resumed as ``-r`` resumes them, one step on the recorded batch: losses,
    sampled parameters and both Adam moments against JAX's recorded next step
    (``chip_smoke.jax_resume_step``, the card's check, here on the CPU)."""
    import chip_smoke

    res = chip_smoke.jax_resume_step(torch, kind, "cpu")
    assert res["step0"] == {"tts": 2, "vocoder": 4}[kind]
    assert res["count0"] == res["step0"]
    assert res["loss_err"] <= chip_smoke.TOL_F32_REL


def test_train_prosody_takes_r_and_ignores_it_as_jax_does(tmp_path):
    """A fault of the reference the port keeps: ``train_prosody`` parses ``-r``
    (the scripts' common arguments) and never reads ``resume.from``
    (``speechflow_tpu/scripts/train_prosody.py``), so a resumed run starts at
    step 0 with fresh moments; the port's does the same."""
    import inspect

    from speechflow_tpu.scripts import train_prosody as JP

    from speechflow_torch.scripts import train_prosody

    assert "resume" not in inspect.getsource(JP)
    expr = train_prosody.main(["-vs", "debug", "--device", "cpu", "--max_steps", "1",
                               "--experiment_dir", str(tmp_path / "a"),
                               "-r", str(tmp_path / "no_such_run")])
    last = ExperimentSaver.get_last_checkpoint(expr)
    assert last.name == "step_000000001"


def test_discriminator_leaky_relu_takes_jaxs_slope_at_zero():
    """Repaired with the resume check: the discriminators' leaky ReLU has
    ``nnx.leaky_relu``'s gradient at exactly 0 (1, not torch's 0.1). A
    discriminator's biases are 0 until its first step at lr > 0, so a chunk's
    silence gives exact zeros, and the bias gradients moved by ~10%."""
    import jax

    from speechflow_torch.models.vocoder.discriminators import leaky_relu

    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    leaky_relu(x, 0.1).sum().backward()
    ref = jax.grad(lambda v: jnp.sum(nnx.leaky_relu(v, negative_slope=0.1)))(
        jnp.asarray([-1.0, 0.0, 2.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(x.grad.numpy(), np.float32([0.1, 1.0, 1.0]))
