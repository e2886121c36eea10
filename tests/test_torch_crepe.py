"""The port's CREPE tracker and yingram against the JAX package (CPU, f32):
logits, ``decode`` and ``crepe_f0`` with JAX's weights converted
(``CREPE_TOL``), the synthetic training batches draw for draw, an
``optax.adamw`` step, ``save_crepe`` pickles across the packages, ``yingram``
on the device path and on the host (``YINGRAM_TOL``), and the ``pitch``
handler's ``crepe`` and ``yingram`` methods."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.data.core.datasample import SpectrogramDataSample as Sample
from speechflow_torch.data.processors import np_dsp
from speechflow_torch.data.processors import spectral as S
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.models.pitch import (
    CrepeF0,
    CrepeParams,
    crepe_f0,
    load_crepe,
    save_crepe,
    synth_pitch_batch,
    train_crepe,
)
from speechflow_torch.ops import pitch as P
from tests.torch_parity import assert_grads_match, n, port, randomize, t

torch.set_num_threads(1)
CREPE_TOL = 1e-5
YINGRAM_TOL = 1e-5
SR = 24000
SMALL = dict(frame_length=256, n_bins=40, channels=(8, 8, 12), kernel_sizes=(16, 8, 4),
             strides=(4, 1, 1), dense_dim=24)


def _jax_crepe(seed: int = 0):
    from speechflow_tpu.models.pitch import CrepeF0 as J
    from speechflow_tpu.models.pitch import CrepeParams as JP

    params = JP.create(SMALL)
    model = randomize(J(params, rngs=nnx.Rngs(0)), seed)
    model.out.bias[...] = model.out.bias[...] + 1.0  # a peak above the threshold: voiced
    return model, params


def _tone(f0: float, seconds: float = 0.3, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tt = np.arange(int(SR * seconds)) / SR
    sig = sum(k ** -1.0 * np.sin(2 * np.pi * k * f0 * tt) for k in range(1, 8))
    return (0.5 * sig / np.abs(sig).max() + 0.01 * rng.normal(size=tt.size)).astype(np.float32)


def test_crepe_logits_decode_and_f0_match_jax():
    from speechflow_tpu.models.pitch import crepe_f0 as jax_f0

    jm, _ = _jax_crepe()
    ours = port(CrepeF0(CrepeParams.create(SMALL)), jm)
    frames = np.random.default_rng(1).normal(size=(9, 256)).astype(np.float32)
    logits = ours(t(frames))
    ref = np.asarray(jm(jnp.asarray(frames)))
    np.testing.assert_allclose(n(logits), ref, atol=CREPE_TOL, rtol=0)
    thr = float(np.median(1.0 / (1.0 + np.exp(-ref.max(-1)))))  # voiced and unvoiced frames
    f0, conf = ours.decode(t(ref), threshold=thr)
    rf0, rconf = jm.decode(jnp.asarray(ref), threshold=thr)
    np.testing.assert_allclose(n(conf), np.asarray(rconf), atol=CREPE_TOL, rtol=0)
    np.testing.assert_allclose(n(f0), np.asarray(rf0), rtol=CREPE_TOL, atol=0)
    assert (n(f0) == 0).any() and (n(f0) > 0).any()

    wav = np.stack([_tone(150.0), _tone(310.0, seed=1)])[:, :7000]
    got = n(crepe_f0(ours, t(wav), sr=SR, hop_length=128))
    want = np.asarray(jax_f0(jm, jnp.asarray(wav), sr=SR, hop_length=128))
    assert got.shape == want.shape == (2, 1 + 7000 // 128)
    np.testing.assert_allclose(got, want, rtol=CREPE_TOL, atol=CREPE_TOL)
    with pytest.raises(ValueError):
        crepe_f0(ours, t(wav), sr=16000)


def test_synth_batches_and_an_adamw_step_match_jax():
    import optax

    from speechflow_tpu.models.pitch.crepe import synth_pitch_batch as jax_synth

    jm, jp = _jax_crepe()
    p = CrepeParams.create(SMALL)
    fr, tg = synth_pitch_batch(np.random.default_rng(3), p, 12)
    jfr, jtg = jax_synth(np.random.default_rng(3), jp, 12)
    np.testing.assert_array_equal(fr, jfr)
    np.testing.assert_array_equal(tg, jtg)

    ours = port(CrepeF0(p), jm).train()

    def loss_fn(m):
        return optax.sigmoid_binary_cross_entropy(m(jnp.asarray(fr)), jnp.asarray(tg)).mean()

    ref_loss, grads = nnx.value_and_grad(loss_fn)(jm)
    loss = torch.nn.functional.binary_cross_entropy_with_logits(ours(t(fr)), t(tg))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=CREPE_TOL)
    assert_grads_match(ours, grads, CREPE_TOL)
    assert ours.cents.grad is None


def test_train_crepe_on_the_cpu():
    losses = []
    model = train_crepe(CrepeParams.create(SMALL), steps=3, batch=8, device="cpu",
                        losses=losses)
    assert len(losses) == 3 and all(np.isfinite(losses)) and not model.training
    from speechflow_torch.models.pitch.crepe import _bin_cents

    np.testing.assert_array_equal(n(model.cents), _bin_cents(CrepeParams.create(SMALL)))


def test_crepe_checkpoints_cross_packages(tmp_path):
    from speechflow_tpu.models.pitch import load_crepe as jax_load
    from speechflow_tpu.models.pitch import save_crepe as jax_save

    jm, _ = _jax_crepe()
    jax_save(jm, tmp_path / "j.pkl")
    ours = load_crepe(tmp_path / "j.pkl", device="cpu")
    frames = np.random.default_rng(4).normal(size=(3, 256)).astype(np.float32)
    np.testing.assert_allclose(n(ours(t(frames))), np.asarray(jm(jnp.asarray(frames))),
                               atol=CREPE_TOL, rtol=0)
    save_crepe(ours, tmp_path / "p.pkl")
    back = jax_load(tmp_path / "p.pkl")
    np.testing.assert_array_equal(np.asarray(back(jnp.asarray(frames))),
                                  np.asarray(jm(jnp.asarray(frames))))
    np.testing.assert_array_equal(np.asarray(back.cents[...]), np.asarray(jm.cents[...]))


@pytest.mark.parametrize("frame_length,lag_max,bins", [(2048, 2047, 20), (1024, 1023, 5)])
def test_yingram_matches_jax(frame_length, lag_max, bins):
    from speechflow_tpu.data.processors import np_dsp as jnp_dsp
    from speechflow_tpu.ops import pitch as JP

    wav = np.concatenate([_tone(180.0, 0.2), _tone(95.0, 0.15, seed=2)])
    kw = dict(hop_length=256, frame_length=frame_length, lag_max=lag_max,
              bins_per_semitone=bins)
    ref = np.asarray(JP.yingram(jnp.asarray(wav[None]), SR, **kw))
    got = n(P.yingram(t(wav[None]), SR, **kw))
    assert got.shape == ref.shape and got.shape[1] == 1 + len(wav) // 256
    np.testing.assert_allclose(got, ref, atol=YINGRAM_TOL * max(1.0, np.abs(ref).max()), rtol=0)
    host = np_dsp.yingram_np(wav, SR, **kw)
    np.testing.assert_array_equal(host, jnp_dsp.yingram_np(wav, SR, **kw))
    np.testing.assert_allclose(got[0], host, atol=YINGRAM_TOL * max(1.0, np.abs(host).max()),
                               rtol=0)
    assert P.yingram_midi_range(SR, 22, lag_max) == JP.yingram_midi_range(SR, 22, lag_max)
    np.testing.assert_array_equal(P.midi_to_lag(SR, [40, 69.5]), JP.midi_to_lag(SR, [40, 69.5]))
    np.testing.assert_array_equal(P.lag_to_midi(SR, [30, 400]), JP.lag_to_midi(SR, [30, 400]))


@pytest.mark.parametrize("method", ["crepe", "yingram"])
def test_pitch_handler_methods_match_jax(method, tmp_path):
    from speechflow_tpu.data.core.datasample import SpectrogramDataSample as JSample
    from speechflow_tpu.data.processors import spectral as JS
    from speechflow_tpu.io import AudioChunk as JChunk
    from speechflow_tpu.models.pitch import save_crepe as jax_save

    wav = np.concatenate([_tone(200.0, 0.25), _tone(120.0, 0.25, seed=3)])
    kw = dict(method=method, frame_length=1024, yingram_bins=10)
    if method == "crepe":
        jm, _ = _jax_crepe()
        jax_save(jm, tmp_path / "crepe.pkl")
        kw["crepe_ckpt"] = str(tmp_path / "crepe.pkl")
        S._CREPE_CACHE[kw["crepe_ckpt"]] = load_crepe(kw["crepe_ckpt"], device="cpu")
    mag_frames = 1 + len(wav) // 256 + 3  # the magnitude's frame count differs: zoomed
    ref = JS.pitch(JSample(audio_chunk=JChunk(data=wav, sr=SR), hop_len=256,
                           magnitude=np.zeros((mag_frames, 5), np.float32)), **kw).pitch
    got = S.pitch(Sample(audio_chunk=AudioChunk(data=wav, sr=SR), hop_len=256,
                         magnitude=np.zeros((mag_frames, 5), np.float32)), **kw).pitch
    assert got.shape == ref.shape and got.shape[0] == mag_frames
    if method == "yingram":
        np.testing.assert_array_equal(got, ref)
        assert got.ndim == 2 and 0.0 <= got.min() and got.max() <= 4.0
    else:
        np.testing.assert_allclose(got, ref, rtol=CREPE_TOL, atol=CREPE_TOL)
        assert (got > 0).any()
        S._CREPE_CACHE.clear()
    with pytest.raises(ValueError):
        S.pitch(Sample(audio_chunk=AudioChunk(data=wav, sr=SR)), method="crepe")
