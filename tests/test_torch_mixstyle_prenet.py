"""The port's ``MixStyle`` and ``PreNet`` (``speechflow_torch/models/tts/common.py``)
against the JAX package's, on the CPU in f32.

``MixStyle``: JAX draws its Beta weights, permutation and gate from one key of
the module's stream; the test takes them from a clone of that stream and injects
them into the port. Training mode mixing (gate on) and not (gate off), and eval
mode; the output and the gradient into the input (the statistics take none, as
JAX's ``stop_gradient``). ``PreNet``: JAX's weights converted, the deterministic
call and its gradients; fresh weights follow flax's initialisers.

Tolerance: ``TOL`` of the largest magnitude (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.convert import load_nnx_state
from speechflow_torch.models.tts.common import MixStyle, MixStyleDraws, PreNet

torch.set_num_threads(1)
TOL = 1e-5


def _close(a, b, what: str) -> None:
    scale = max(float(np.abs(b).max()), 1e-12)
    assert float(np.abs(np.asarray(a) - np.asarray(b)).max()) <= TOL * scale, what


def _jax_draws(jm, batch: int) -> MixStyleDraws:
    """The draws JAX's next call takes, from a clone of its stream."""
    k_beta, k_perm, k_gate = jax.random.split(nnx.clone(jm).rngs.params(), 3)
    return MixStyleDraws(
        torch.from_numpy(np.array(jax.random.beta(k_beta, jm.alpha, jm.alpha,
                                                    (batch, 1, 1)))),
        torch.from_numpy(np.array(jax.random.permutation(k_perm, batch))),
        torch.tensor(bool(jax.random.bernoulli(k_gate, jm.p))))


@pytest.mark.parametrize("p,training", [(1.0, True), (0.0, True), (0.5, False)],
                         ids=["mixes", "gate_off", "eval"])
def test_mixstyle_matches_jax(p, training):
    from speechflow_tpu.models.tts.common import MixStyle as JMixStyle

    x = np.random.default_rng(0).normal(1.0, 2.0, size=(5, 17, 6)).astype(np.float32)
    cot = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    jm = JMixStyle(p=p, alpha=0.3, rngs=nnx.Rngs(3))
    draws = _jax_draws(jm, x.shape[0])
    assert bool(draws.gate) == (p == 1.0) or not training
    graph, state = nnx.split(jm)
    want, vjp = jax.vjp(lambda a, st: nnx.merge(graph, st)(a, training=training),
                        jnp.asarray(x), state)
    want_dx = vjp(jnp.asarray(cot))[0]
    xt = torch.tensor(x, requires_grad=True)
    got = MixStyle(p=p, alpha=0.3)(xt, training=training, draws=draws)
    got.backward(torch.from_numpy(cot))
    _close(got.detach().numpy(), want, "output")
    _close(xt.grad.numpy(), want_dx, "input gradient")
    if p == 1.0:  # the statistics are detached: the gradient is cot / sig * sig_mix
        assert not np.allclose(np.asarray(want), x)


def test_mixstyle_draws_come_from_the_generator():
    m = MixStyle(p=0.5, alpha=0.1)
    cpu = torch.device("cpu")
    a = m.draw(8, cpu, torch.Generator().manual_seed(4))
    b = m.draw(8, cpu, torch.Generator().manual_seed(4))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert sorted(a.perm.tolist()) == list(range(8)) and a.lmda.shape == (8, 1, 1)
    assert ((a.lmda >= 0) & (a.lmda <= 1)).all()
    gates = [bool(m.draw(2, cpu, torch.Generator().manual_seed(s)).gate) for s in range(40)]
    assert 5 < sum(gates) < 35


def test_prenet_matches_jax_with_converted_weights():
    from speechflow_tpu.models.tts.common import PreNet as JPreNet

    jm = JPreNet(20, dim=32, dim_out=24, dropout=0.5, rngs=nnx.Rngs(0))
    tm = load_nnx_state(PreNet(20, dim=32, dim_out=24, dropout=0.5),
                        nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
    x = np.random.default_rng(2).normal(size=(3, 11, 20)).astype(np.float32)
    cot = np.random.default_rng(3).normal(size=(3, 11, 24)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jm(a, deterministic=True), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(cot))
    xt = torch.tensor(x, requires_grad=True)
    got = tm(xt)
    got.backward(torch.from_numpy(cot))
    _close(got.detach().numpy(), want, "output")
    _close(xt.grad.numpy(), want_dx, "input gradient")
    # training drops at the rate: about half the units of each layer are zero
    torch.manual_seed(0)
    out = tm(torch.from_numpy(x), deterministic=False)
    assert 0.55 < float((out == 0).float().mean()) < 0.95


def test_fresh_prenet_weights_follow_flax_initialisers():
    torch.manual_seed(0)
    m = PreNet(400, dim=300, dim_out=200)
    for lin, fan_in in ((m.l1, 400), (m.l2, 300)):
        assert not lin.bias.any()
        std = float(lin.weight.detach().std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05  # lecun-normal, truncated at 2 sigma
        assert float(lin.weight.detach().abs().max()) <= 2.0 * 1.1374 / fan_in ** 0.5
