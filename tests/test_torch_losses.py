"""The port's loss zoo (``speechflow_torch/training/losses``) against the JAX
package's, on the CPU in f32: each of the twelve ``LOSSES`` entries built by
``build_loss`` under the same name and arguments, its value and its gradient
(``jax.grad`` against autograd) with lengths and without; the soft-DTW at 1, 2
and 37 frames; the schedules.

Tolerance: ``TOL`` of the JAX value's (or gradient's) largest magnitude (f32;
the two sides sum in other orders, and the port's soft-DTW runs the recursion
along anti-diagonals where JAX's scans rows and columns).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechflow_torch.training.losses import LOSSES, build_loss
from speechflow_torch.training.losses.zoo import SOFT_DTW_BIG, soft_dtw

torch.set_num_threads(1)
TOL = 2e-5
B = 3


def _lengths(t: int) -> np.ndarray:
    return np.array([t, t - 3, t // 2], np.int32)


def _spectral(rng, lens):
    out, tgt = rng.normal(size=(2, B, 20, 6)).astype(np.float32)
    return out, tgt, {"lengths": _lengths(20) if lens else None}


def _gate(rng, lens):
    out = rng.normal(size=(B, 20)).astype(np.float32)
    tgt = (rng.uniform(size=(B, 20)) > 0.8).astype(np.float32)
    return out, tgt, {"lengths": _lengths(20) if lens else None}


def _regression(rng, lens):
    out = rng.normal(size=(B, 15)).astype(np.float32)
    tgt = rng.uniform(0.5, 9.0, size=(B, 15)).astype(np.float32)
    return out, tgt, {"lengths": _lengths(15) if lens else None}


def _vae(rng, lens):
    mu, logvar = rng.normal(size=(2, B, 16)).astype(np.float32)
    return (mu, 0.3 * logvar), None, {"lengths": _lengths(16) if lens else None}


def _mle(rng, lens):
    z = rng.normal(size=(B, 18, 5)).astype(np.float32)
    logdet = rng.normal(size=(B,)).astype(np.float32)
    return (z, logdet), None, {"lengths": _lengths(18) if lens else None, "n_dims": 3}


def _guided(rng, lens):
    att = rng.uniform(size=(B, 24, 10)).astype(np.float32)
    kw = {"in_lengths": np.array([10, 7, 4], np.int32),
          "out_lengths": np.array([24, 20, 9], np.int32)} if lens else {}
    return att, None, kw


def _speaker(rng, lens):
    out = rng.normal(size=(B, 7)).astype(np.float32)
    return out, np.array([0, 6, 3], np.int32), {"lengths": _lengths(7) if lens else None}


def _soft_dtw(rng, lens):
    out, tgt = rng.normal(size=(2, B, 12, 2)).astype(np.float32)
    return out, tgt[:, :9], {"lengths": _lengths(12) if lens else None}


def _ssim(rng, lens):
    # three scales need sides of 44 or more; values inside the [-4, 4] range and
    # the target near the output, away from the clip's and max(., 0)'s kinks
    out = rng.uniform(-3.0, 3.0, size=(2, 48, 46)).astype(np.float32)
    tgt = (out + 0.3 * rng.normal(size=out.shape)).clip(-3.5, 3.5).astype(np.float32)
    return out, tgt, {"lengths": np.array([48, 40], np.int32) if lens else None}


def _ctc(rng, lens):
    out = rng.normal(size=(B, 16, 5)).astype(np.float32)
    tgt = np.array([[1, 2, 3, 0], [4, 4, 0, 0], [2, 0, 0, 0]], np.int32)
    kw = {"lengths": np.array([16, 12, 9], np.int32),
          "target_lengths": np.array([3, 2, 1], np.int32)} if lens else {}
    return out, tgt, kw


CASES = {
    "Spectral": ({"kind": "l2"}, _spectral),
    "Gate": ({"pos_weight": 2.0}, _gate),
    "Regression": ({"kind": "l1", "log_domain": True}, _regression),
    "Duration": ({}, _regression),
    "VAE": ({}, _vae),
    "MLE": ({}, _mle),
    "GuidedAttention": ({"sigma": 0.3}, _guided),
    "InverseSpeaker": ({}, _speaker),
    "SoftDTW": ({"gamma": 0.5}, _soft_dtw),
    "DiffSpectral": ({"kind": "l1"}, _spectral),
    "SSIM": ({}, _ssim),
    "CTC": ({"blank_id": 0}, _ctc),
}


def test_the_zoo_has_jaxs_names():
    from speechflow_tpu.training.losses import LOSSES as JLOSSES

    assert set(LOSSES) == set(JLOSSES) == set(CASES)
    for name in LOSSES:
        assert LOSSES[name].__name__ == JLOSSES[name].__name__


def _as(x, fn):
    if x is None:
        return None
    return tuple(fn(a) for a in x) if isinstance(x, tuple) else fn(x)


def _value_and_grads(name: str, kwargs: dict, output, target, call_kw: dict):
    """(JAX's value, JAX's gradients, the port's value, the port's gradients)."""
    from speechflow_tpu.training.losses import build_loss as jbuild

    jloss, loss = jbuild(name, **kwargs), build_loss(name, **kwargs)
    jkw = {k: (v if v is None or np.isscalar(v) else jnp.asarray(v))
           for k, v in call_kw.items()}
    jtgt = _as(target, jnp.asarray)
    jval, jgrad = jax.value_and_grad(lambda o: jloss(o, jtgt, **jkw))(_as(output, jnp.asarray))
    tout = _as(output, lambda a: torch.tensor(a, requires_grad=True))
    tkw = {k: (v if v is None or np.isscalar(v) else torch.from_numpy(v))
           for k, v in call_kw.items()}
    val = loss(tout, _as(target, torch.from_numpy), **tkw)
    val.backward()
    grads = _as(tout, lambda t: t.grad.numpy())
    flat = (lambda g: list(g) if isinstance(g, tuple) else [g])
    return float(jval), [np.asarray(g) for g in flat(jgrad)], float(val), flat(grads)


@pytest.mark.parametrize("lens", [True, False], ids=["lengths", "no_lengths"])
@pytest.mark.parametrize("name", list(CASES))
def test_each_loss_and_its_gradient_match_jax(name, lens):
    kwargs, make = CASES[name]
    output, target, call_kw = make(np.random.default_rng(len(name)), lens)
    jval, jgrads, val, grads = _value_and_grads(name, kwargs, output, target, call_kw)
    assert np.isfinite(jval) and abs(val - jval) <= TOL * max(abs(jval), 1e-6), (val, jval)
    for g, jg in zip(grads, jgrads):
        scale = max(float(np.abs(jg).max()), 1e-12)
        assert float(np.abs(g - jg).max()) <= TOL * scale, name
    assert any(np.abs(jg).max() > 0 for jg in jgrads)


def _jax_recursion(cost: np.ndarray, textbook: bool = False) -> np.ndarray:
    """JAX's soft-DTW recursion (γ = 1) cell by cell in float64: the diagonal
    predecessor of row i is D[i-2, j-1] (``textbook``: D[i-1, j-1])."""
    tx, ty = cost.shape[1:]
    d = np.full((cost.shape[0], tx + 2, ty + 1), SOFT_DTW_BIG)  # D[i, j] at [i + 2, j + 1]
    for i in range(tx):
        for j in range(ty):
            if i == 0 or textbook:
                diag = d[:, i + 1, j] if (i, j) != (0, 0) else np.zeros(len(cost))
            else:
                diag = d[:, i, j] if i >= 2 else np.full(len(cost), SOFT_DTW_BIG)
            prev = np.stack([d[:, i + 1, j + 1], d[:, i + 2, j], diag])
            d[:, i + 2, j + 1] = cost[:, i, j] - np.log(np.exp(-prev).sum(0))
    return d[:, tx + 1, ty]


@pytest.mark.parametrize("t", [1, 2, 37])
def test_soft_dtw_at_1_2_and_37_frames(t):
    """The wavefront against JAX's row-column scan, square and not, with its
    gradient; and against JAX's recursion written cell by cell in float64, which
    from the third row takes the diagonal two rows back (ROADMAP §3: a fault of
    the reference the port keeps)."""
    rng = np.random.default_rng(t)
    out = rng.normal(size=(2, t, 3)).astype(np.float32)
    tgt = rng.normal(size=(2, max(t - 1, 1), 3)).astype(np.float32)
    for o, g in ((out, out[::-1].copy()), (out, tgt)):
        jval, jgrads, val, grads = _value_and_grads("SoftDTW", {}, o, g, {})
        assert abs(val - jval) <= TOL * abs(jval)
        assert float(np.abs(grads[0] - jgrads[0]).max()) <= TOL * np.abs(jgrads[0]).max()
    cost = rng.uniform(size=(2, t, t + 3))
    got = soft_dtw(torch.from_numpy(cost)).numpy()
    np.testing.assert_allclose(got, _jax_recursion(cost), rtol=1e-12)
    if t >= 3:
        assert np.abs(got - _jax_recursion(cost, textbook=True)).max() > 1e-3


def test_build_loss_carries_the_schedule():
    from speechflow_tpu.training.losses import build_loss as jbuild

    kw = dict(scale=2.0, begin_iter=2, end_iter=8, every_iter=2, anneal_iters=4)
    out, tgt, call_kw = _ssim(np.random.default_rng(0), True)
    loss, jloss = build_loss("SSIM", **kw), jbuild("SSIM", **kw)
    assert loss.name == jloss.name == "SSIM"
    for step in range(10):
        got = float(loss(torch.from_numpy(out), torch.from_numpy(tgt), step=step,
                         lengths=torch.from_numpy(call_kw["lengths"])))
        want = float(jloss(jnp.asarray(out), jnp.asarray(tgt), step=jnp.asarray(step),
                           lengths=jnp.asarray(call_kw["lengths"])))
        assert abs(got - want) <= TOL * max(abs(want), 1e-6), step
    with pytest.raises(KeyError):
        build_loss("Unknown")
