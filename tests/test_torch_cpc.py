"""The port's CPC model against the JAX package (CPU, f32): features, latents,
the InfoNCE loss and its gradients with JAX's weights converted (``CPC_TOL``),
``save_module`` pickles across the packages, the ``ssl_features`` handler over
a CPC checkpoint, the vocoder's CPC perceptual loss with its gradient into the
fake waveform (the frozen CPC gets none), and ``train_vocoder`` with
``loss.cpc_ckpt``."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.data.core.datasample import AudioDataSample as Sample
from speechflow_torch.data.processors import embeddings as E
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.models.ssl import CPCModel, CPCParams, cpc_infonce_loss, train_cpc
from speechflow_torch.models.vocoder.criterion import (
    make_cpc_perceptual_loss,
    vocoder_gen_criterion,
)
from speechflow_torch.utils.state_io import load_module, save_module
from tests.torch_parity import assert_grads_match, n, port, randomize, t

torch.set_num_threads(1)
CPC_TOL = 1e-5
SMALL = dict(channels=16, latent_dim=12, context_dim=10, strides=(5, 4, 2),
             kernel_sizes=(10, 8, 4), n_predict_steps=3)


def _jax_cpc(seed: int = 0):
    from speechflow_tpu.models.ssl import CPCModel as J
    from speechflow_tpu.models.ssl import CPCParams as JP

    params = JP.create(SMALL)
    return randomize(J(params, rngs=nnx.Rngs(0)), seed), params


def _waves(seed: int, b: int, length: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tt = np.arange(length) / 24000
    f0 = rng.uniform(100, 300, (b, 1))
    return (0.3 * np.sin(2 * np.pi * f0 * tt) + 0.05 * rng.normal(size=(b, length))
            ).astype(np.float32)


def _jax_ckpt(tmp_path):
    from speechflow_tpu.utils.state_io import save_module as jax_save

    jm, jp = _jax_cpc()
    return jm, jax_save(jm, jp, tmp_path / "cpc_jax.pkl")


def test_cpc_features_loss_and_gradients_match_jax():
    from speechflow_tpu.models.ssl import cpc_infonce_loss as jax_loss

    jm, _ = _jax_cpc()
    ours = port(CPCModel(CPCParams.create(SMALL)), jm)
    wav = _waves(0, 3, 1597)  # not a multiple of the hop: SAME pads at each stride
    c_ref, z_ref = jm.features_and_latents(jnp.asarray(wav))
    c, z = ours.features_and_latents(t(wav))
    assert tuple(c.shape) == (3, 40, 10) and tuple(z.shape) == (3, 40, 12)
    np.testing.assert_allclose(n(z), np.asarray(z_ref), atol=CPC_TOL, rtol=0)
    np.testing.assert_allclose(n(c), np.asarray(c_ref), atol=CPC_TOL, rtol=0)
    np.testing.assert_allclose(n(ours(t(wav))), np.asarray(jm(jnp.asarray(wav))),
                               atol=CPC_TOL, rtol=0)

    ref_loss, ref_grads = nnx.value_and_grad(lambda m: jax_loss(m, jnp.asarray(wav)))(jm)
    loss = cpc_infonce_loss(ours, t(wav))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=CPC_TOL)
    assert_grads_match(ours, ref_grads, CPC_TOL)


def test_cpc_checkpoints_cross_packages(tmp_path):
    from speechflow_tpu.models.ssl import CPCModel as J
    from speechflow_tpu.models.ssl import CPCParams as JP
    from speechflow_tpu.utils.state_io import load_module as jax_load

    jm, path = _jax_ckpt(tmp_path)
    ours, params = load_module(CPCModel, CPCParams, path, device="cpu")
    assert params.strides == (5, 4, 2)
    wav = _waves(1, 2, 1200)
    np.testing.assert_allclose(n(ours(t(wav))), np.asarray(jm(jnp.asarray(wav))),
                               atol=CPC_TOL, rtol=0)
    back, back_params = jax_load(J, JP, save_module(ours, params, tmp_path / "cpc_port.pkl"))
    assert tuple(back_params.kernel_sizes) == (10, 8, 4)
    np.testing.assert_array_equal(np.asarray(back(jnp.asarray(wav))),
                                  np.asarray(jm(jnp.asarray(wav))))


def test_ssl_features_match_jax(tmp_path):
    from speechflow_tpu.data.core.datasample import AudioDataSample as JSample
    from speechflow_tpu.data.processors import embeddings as JE
    from speechflow_tpu.io import AudioChunk as JChunk

    _, path = _jax_ckpt(tmp_path)
    wav = _waves(2, 1, 7000)[0]
    ref = JE.ssl_features(JSample(audio_chunk=JChunk(data=wav, sr=24000)),
                          model_ckpt=str(path)).ssl_feat
    E.set_ssl_model(E.make_cpc_hook(str(path), device="cpu"))
    try:
        got = E.ssl_features(Sample(audio_chunk=AudioChunk(data=wav, sr=24000)),
                             model_ckpt=str(path)).ssl_feat
    finally:
        E.set_ssl_model(None)
    assert got.shape == ref.shape == (7000 // 40, 10)
    np.testing.assert_allclose(got, ref, atol=CPC_TOL, rtol=0)


def test_cpc_perceptual_loss_and_its_gradient(tmp_path):
    from speechflow_tpu.models.vocoder.criterion import (
        make_cpc_perceptual_loss as jax_make,
    )

    _, path = _jax_ckpt(tmp_path)
    fake, real = _waves(3, 2, 2000), _waves(4, 2, 2000)
    jloss = jax_make(str(path))
    ref, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(fake), jnp.asarray(real))
    loss_fn = make_cpc_perceptual_loss(str(path), device="cpu")
    x = t(fake).requires_grad_()
    r = t(real).requires_grad_()
    loss = loss_fn(x, r)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref), rtol=CPC_TOL)
    scale = float(np.abs(np.asarray(ref_grad)).max())
    assert float(np.abs(n(x.grad) - np.asarray(ref_grad)).max()) <= CPC_TOL * scale
    assert r.grad is None  # the real branch carries no gradient
    assert all(p.grad is None and not p.requires_grad for p in loss_fn.model.parameters())


def test_gen_criterion_cpc_term_matches_jax(tmp_path):
    from speechflow_tpu.models.vocoder.criterion import vocoder_gen_criterion as jax_crit

    _, path = _jax_ckpt(tmp_path)
    fake, real = _waves(5, 2, 4096), _waves(6, 2, 4200)

    def disc(x):  # a fixed stand-in: one logit map and one feature map
        return [x[:, :64]], [[x[:, ::7]]]

    kw = dict(n_mels=20, cpc_ckpt=str(path), cpc_weight=0.5)
    ref = jax_crit(**kw)(jnp.asarray(fake), disc, {}, {"waveform": jnp.asarray(real)},
                         jnp.asarray(0))
    got = vocoder_gen_criterion(device="cpu", **kw)(t(fake), disc, {}, {"waveform": t(real)}, 0)
    assert list(got) == list(ref) == ["mel", "stft", "adv", "fm", "cpc"]
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=2e-5, err_msg=k)


def test_train_cpc_on_the_cpu():
    losses = []
    model = train_cpc([_waves(7, 1, 5000)[0], _waves(8, 1, 900)[0]], steps=3, batch=2,
                      chunk_s=0.05, params=CPCParams.create(SMALL), device="cpu",
                      losses=losses)
    assert len(losses) == 3 and all(np.isfinite(losses)) and not model.training


def test_train_vocoder_with_cpc_loss(tmp_path):
    """``train_vocoder`` at the debug preset with ``loss.cpc_ckpt`` (a port
    checkpoint): 2 steps on the CPU log a finite ``gen/cpc``, and the CPC
    pickle is unchanged."""
    from pathlib import Path

    from speechflow_torch.scripts import train_vocoder as TV

    ckpt = save_module(CPCModel(CPCParams.create(SMALL)), CPCParams.create(SMALL),
                       tmp_path / "cpc.pkl")
    before = ckpt.read_bytes()
    repo = Path(__file__).resolve().parents[1]
    text = (repo / "configs" / "vocoder_bigvgan.yml").read_text()
    text = re.sub(r"^loss:\n", f"loss:\n  cpc_ckpt: {ckpt}\n  cpc_weight: 0.5\n", text,
                  flags=re.M)
    cfg = tmp_path / "vocoder_cpc.yml"
    cfg.write_text(text)
    seen = []

    def callback(trainer, last):
        seen.append({k: float(v) for k, v in last.items()})

    model_cfg, data_cfg = TV.configs("debug", cfg, data_root=repo / "tests" / "data" / "SEGS")
    assert model_cfg["loss"]["cpc_ckpt"] == str(ckpt)
    model_cfg["trainer"]["max_steps"] = 2
    model_cfg["data_loaders"]["n_workers"] = 0
    from speechflow_torch.scripts.common import experiment_saver

    TV.train(model_cfg, data_cfg, experiment_saver(model_cfg, data_cfg, tmp_path / "exp"),
             device="cpu", callbacks=[callback])
    assert len(seen) == 2 and all(np.isfinite(s["gen/cpc"]) and s["gen/cpc"] > 0 for s in seen)
    assert ckpt.read_bytes() == before


@pytest.mark.parametrize("bad", [None, ""])
def test_no_cpc_term_without_a_checkpoint(bad):
    crit = vocoder_gen_criterion(n_mels=20, cpc_ckpt=bad, device="cpu")
    wav = t(_waves(9, 1, 2048))
    out = crit(wav, lambda x: ([x[:, :8]], [[x]]), {}, {"waveform": wav}, 0)
    assert "cpc" not in out
