"""The port's encoder zoo (``speechflow_torch.models.tts.encoders``) against the JAX
package's, on the CPU: each of JAX's twelve registered names builds the same
parameter tree, and with the same random weights (``torch_parity.randomize``,
copied by ``convert``) and the same padded batch the outputs agree, at an even and
an odd output width; the recurrent ones (bi-GRU, bi-LSTM) also in their input
gradient. Tolerance: float32, 1e-5 of the output's scale (2e-5 through the
recurrences, whose 9 steps compound rounding)."""

import numpy as np
import pytest
import torch
from flax import nnx

import jax.numpy as jnp
from speechflow_torch.models.tts.encoders import TTS_ENCODERS
from tests.torch_parity import n, port, randomize, t

torch.set_num_threads(1)

B, N, DIM_IN = 3, 9, 10
LENS = np.array([9, 6, 3], np.int32)
KW = dict(dim=16, n_layers=2, n_heads=2, dropout=0.1, cond_dim=6, ling_feat_dim=5,
          lm_feat_dim=4)


def _inputs(rng, dim_in: int = DIM_IN):
    x = rng.normal(size=(B, N, dim_in)).astype(np.float32)
    extra = {"sf": {"pitch": rng.uniform(0, 400, (B, N)).astype(np.float32),
                    "energy": rng.uniform(0, 100, (B, N)).astype(np.float32)},
             "ling_condition": {"ling_feat": rng.normal(size=(B, N, 5)).astype(np.float32),
                                "lm_feat": rng.normal(size=(B, N, 4)).astype(np.float32)}}
    return x, rng.normal(size=(B, 6)).astype(np.float32), extra


def _pair(name: str, dim_out: int, **kw):
    from speechflow_tpu.models.tts.encoders import TTS_ENCODERS as J

    # the JAX DummyEncoder builds only where no projection is needed (ROADMAP §3)
    dim_in = dim_out if name == "dummy" else DIM_IN
    args = dict(KW, dim_in=dim_in, dim_out=dim_out, **kw)
    jm = randomize(J[name](rngs=nnx.Rngs(0), **args), seed=3)
    return jm, port(TTS_ENCODERS[name](**args), jm)


def _outs(o):
    return o if isinstance(o, list) else [o]


@pytest.mark.parametrize("dim_out", [12, 11])
@pytest.mark.parametrize("name", sorted(TTS_ENCODERS))
def test_encoder_matches_jax(name, dim_out):
    """Inference call (no dropout) on a padded batch; a VQ encoder's codes and
    loss, each stream of a multi-stream context encoder."""
    rng = np.random.default_rng(0)
    x, cond, extra = _inputs(rng, dim_out if name == "dummy" else DIM_IN)
    kw = {"concat": False} if name == "context" else {}
    jm, tm = _pair(name, dim_out, **kw)
    jx = {k: jnp.asarray(v) for k, v in extra.get(name, {}).items()}
    ref = jm(jnp.asarray(x), jnp.asarray(LENS), jnp.asarray(cond), deterministic=True, **jx)
    with torch.no_grad():
        out = tm(t(x), t(LENS), t(cond), deterministic=True,
                 **{k: t(v) for k, v in extra.get(name, {}).items()})
    valid = np.arange(N)[None, :] < LENS[:, None]
    tol = 2e-5 if name in ("rnn", "variance_encoder", "sf") else 1e-5
    for o, r in zip(_outs(out), _outs(ref), strict=True):
        r = np.asarray(r)
        assert o.shape == r.shape
        rows = valid if name != "dummy" else np.ones_like(valid)
        np.testing.assert_allclose(n(o)[rows], r[rows], atol=tol * np.abs(r).max())
    if name == "vq":
        a, b = tm.pop_aux(), jm.pop_aux()
        np.testing.assert_array_equal(n(a["vq_codes"]), np.asarray(b["vq_codes"]))
        np.testing.assert_allclose(float(a["vq_loss"]), float(b["vq_loss"]), rtol=1e-5)
        assert tm.pop_aux() == {}


@pytest.mark.parametrize("name", ["rnn", "variance_encoder"])
def test_recurrent_encoder_gradients_match_jax(name):
    """The input gradient of <output, cotangent> through the bi-GRU / bi-LSTM,
    padded steps included (JAX's backward GRU runs over them too)."""
    rng = np.random.default_rng(1)
    x, _, _ = _inputs(rng)
    jm, tm = _pair(name, 11)
    ct = rng.normal(size=(B, N, 11)).astype(np.float32)
    ref = nnx.grad(lambda m, v: jnp.sum(m(v, jnp.asarray(LENS)) * ct), argnums=1)(
        jm, jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    (tm(xt, t(LENS)) * t(ct)).sum().backward()
    ref = np.asarray(ref)
    np.testing.assert_allclose(n(xt.grad), ref, atol=2e-5 * np.abs(ref).max())


def test_rnn_encoder_takes_no_depth_and_runs_over_padding():
    """A fault of the reference that the port keeps: ``RNNEncoder`` builds one
    bi-GRU layer whatever ``n_layers`` says (``tts_forward.yml``'s 2 layers are
    one), and its backward GRU starts at the padded tail, so a shorter row's
    valid outputs depend on what its padding holds."""
    _, tm = _pair("rnn", 12)
    assert sorted(n for n, _ in tm.named_children()) == ["bwd", "fwd"]
    rng = np.random.default_rng(2)
    x, _, _ = _inputs(rng)
    x2 = x.copy()
    x2[2, LENS[2]:] += 1.0  # only the padding of the last row changes
    with torch.no_grad():
        a, b = tm(t(x), t(LENS)), tm(t(x2), t(LENS))
    assert torch.equal(a[:2], b[:2]) and not torch.allclose(a[2], b[2])
    assert torch.equal(a[2, :LENS[2], :6], b[2, :LENS[2], :6])  # the forward half


def test_recurrent_cells_carry_flax_parameters_only():
    """flax's GRU has no hidden bias and its LSTM no input bias: the port holds
    no parameter for either (a trained zero would break ``convert``'s strict
    map), and the recurrent kernels start orthogonal under ``flax_init_``."""
    from speechflow_torch.models.layers import RNN, flax_init_

    gru, lstm = RNN("gru", 5, 4), RNN("lstm", 5, 4)
    assert sorted(n for n, _ in gru.named_parameters()) == [
        "cell.dense_h.weight", "cell.dense_i.bias", "cell.dense_i.weight"]
    assert sorted(n for n, _ in lstm.named_parameters()) == [
        "cell.dense_h.bias", "cell.dense_h.weight", "cell.dense_i.weight"]
    torch.manual_seed(0)
    for m in (gru, lstm):
        flax_init_(m)
        w = m.cell.dense_h.weight.detach()
        torch.testing.assert_close(w.T @ w, torch.eye(4), atol=1e-5, rtol=0)
