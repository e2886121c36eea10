"""The port's training examples and ``TripletSampler`` against the JAX
package (CPU): the sampler's triplets draw for draw from one seed; one
``optax.adam`` step of the codec example and of the biometric example on the
same batch and JAX's weights converted (losses within ``STEP_TOL``, the
parameters after the step within ``STEP_TOL`` plus what AdamW's first step
makes of the gradients' rounding); and each example's ``main`` on the CPU,
its ``--save`` pickle read by the handler that serves it in both packages."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from speechflow_torch.convert import _mappings, flatten_nnx
from speechflow_torch.data.core.components import DataPipeline
from speechflow_torch.data.parsers import AudioDSParser
from speechflow_torch.data.samplers import SAMPLERS, TripletSampler
from speechflow_torch.examples.biometric import train as BT
from speechflow_torch.examples.codec import train as CT
from speechflow_torch.io.flist import construct_file_list
from tests.torch_parity import n, port, t

torch.set_num_threads(1)
STEP_TOL = 1e-5
SEGS = Path(__file__).resolve().parent / "data" / "SEGS"


def _datasets():
    from speechflow_tpu.data.parsers import AudioDSParser as JParser
    from speechflow_tpu.io import construct_file_list as jax_files

    files = construct_file_list(SEGS, ext=".wav")
    assert files == jax_files(str(SEGS), ext=".wav")
    return AudioDSParser().read_datasamples(files), JParser().read_datasamples(files)


def test_triplet_sampler_matches_jax():
    from speechflow_tpu.data.samplers import SAMPLERS as JSAMPLERS

    ours, ref = _datasets()
    assert SAMPLERS["TripletSampler"] is TripletSampler
    a = TripletSampler(seed=3).set_dataset(ours)
    b = JSAMPLERS["TripletSampler"](seed=3).set_dataset(ref)
    for size in (4, 7, 30, 4):  # across an epoch's end
        (sa, la), (sb, lb) = a.sampling(size), b.sampling(size)
        assert la == lb and len(sa) == 3 * size
        assert [s.file_path for s in sa] == [s.file_path for s in sb]
        k = len(sa) // 3
        assert all(x.speaker_name == y.speaker_name != z.speaker_name
                   for x, y, z in zip(sa[:k], sa[k:2 * k], sa[2 * k:]))
    with pytest.raises(ValueError):
        TripletSampler(field="index").set_dataset(ours)


def test_triplet_sampler_builds_from_a_data_config():
    """A data config's ``sampler: {type: TripletSampler}`` builds (the vocoder
    data config with its sampler swapped)."""
    from speechflow_torch.scripts import train_vocoder as TV

    _, data_cfg = TV.configs("debug", data_root=SEGS)
    data_cfg["dataset"]["max_num_samples"] = None
    data_cfg["sampler"] = {"type": "TripletSampler", "field": "speaker_name", "seed": 2}
    dp = DataPipeline.from_config(data_cfg)
    assert all(isinstance(s, TripletSampler) and s.seed == 2 for s in dp.samplers.values())
    samples, _ = dp.samplers["train"].sampling(3)
    assert len(samples) == 9


def _held_step(jm, ours, loss_j, step_p, lr):
    """One adam step in both packages; each parameter within STEP_TOL plus
    lr·|u_port - u_jax| of the first step's gradients (u = g/(|g| + eps))."""
    opt = nnx.Optimizer(jm, optax.adam(lr), wrt=nnx.Param)
    ref_loss, grads = nnx.value_and_grad(loss_j)(jm)
    opt.update(jm, grads)
    from speechflow_torch.training.optimizer import optax_optimizer

    p_opt = optax_optimizer(ours.parameters(), "adam", lr)
    saved = {}

    def keep_grads():
        for name, p in ours.named_parameters():
            saved[name] = p.grad.detach().clone()

    real_step = p_opt.step

    def step():
        keep_grads()
        real_step()

    p_opt.step = step
    loss = step_p(ours, p_opt)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=STEP_TOL)
    flat_g = flatten_nnx(nnx.to_pure_dict(grads))
    flat_p = flatten_nnx(nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
    for name, param, src, _, to_flax in _mappings(ours):
        g_p, g_j = to_flax(n(saved[name])), flat_g[src]
        lim = STEP_TOL + lr * np.abs(g_p / (np.abs(g_p) + 1e-8) - g_j / (np.abs(g_j) + 1e-8))
        err = np.abs(to_flax(n(param)) - flat_p[src])
        assert (err <= lim).all(), (name, float(err.max()))


def test_codec_example_step_matches_jax():
    from speechflow_tpu.models.codec import CodecParams as JP
    from speechflow_tpu.models.codec import NeuralCodec as J
    from speechflow_tpu.models.codec.rvq import codec_criterion as jax_crit

    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.models.codec import CodecParams, NeuralCodec
    from speechflow_torch.models.codec.rvq import codec_criterion

    waves = [AudioChunk(file_path=f).load(sr=24000).waveform
             for f in construct_file_list(SEGS, ext=".wav")[:4]]
    wav = CT.draw_batch(np.random.default_rng(0), waves, 2, 2048)
    jm = J(JP.create(CT.PARAMS), rngs=nnx.Rngs(0))
    ours = port(NeuralCodec(CodecParams.create(CT.PARAMS)), jm).train()
    crit_j = jax_crit(sample_rate=24000)

    def loss_j(m):
        return sum(crit_j(m(jnp.asarray(wav)), {"waveform": jnp.asarray(wav)}, 0).values())

    _held_step(jm, ours, loss_j,
               lambda m, o: CT.codec_step(m, o, codec_criterion(sample_rate=24000), t(wav)),
               3e-4)


def test_biometric_example_step_matches_jax():
    from speechflow_tpu.data.processors.audio import load_audio, random_chunk
    from speechflow_tpu.data.processors.spectral import amp_to_db, linear_to_mel, magnitude
    from speechflow_tpu.models.biometric import ECAPAEmbedder as J
    from speechflow_tpu.models.biometric import ECAPAParams as JP
    from speechflow_tpu.models.biometric.ecapa import triplet_loss as jax_triplet

    from speechflow_torch.models.biometric import ECAPAEmbedder, ECAPAParams

    ours_ds, ref_ds = _datasets()
    samples, _ = TripletSampler().set_dataset(ours_ds).sampling(2)
    mel = BT.triplet_mels(samples)

    def jax_featurize(ds):  # the JAX example's
        ds = load_audio(ds, sample_rate=24000)
        ds = random_chunk(ds, chunk_duration=1.5, seed=ds.index)
        ds = magnitude(ds, n_fft=1024, hop_len=256)
        ds = linear_to_mel(ds, n_mels=80)
        return amp_to_db(ds)

    by_path = {s.file_path: s for s in ref_ds}
    ref_mels = [jax_featurize(by_path[s.file_path].copy()).mel[:128] for s in samples]
    for i, m in enumerate(ref_mels):
        np.testing.assert_allclose(mel[i, :len(m)], m, atol=1e-4, rtol=0)

    jm = J(JP.create(BT.PARAMS), rngs=nnx.Rngs(0))
    ours = port(ECAPAEmbedder(ECAPAParams.create(BT.PARAMS)), jm).train()

    def loss_j(m):
        a, p, q = jnp.split(m(jnp.asarray(mel)), 3, axis=0)
        return jax_triplet(a, p, q)

    _held_step(jm, ours, loss_j, lambda m, o: BT.triplet_step(m, o, t(mel)), 1e-3)


@pytest.mark.parametrize("example", ["codec", "biometric"])
def test_example_main_saves_what_the_handlers_read(example, tmp_path):
    from speechflow_tpu.data.core.datasample import AudioDataSample as JSample
    from speechflow_tpu.data.processors import embeddings as JE
    from speechflow_tpu.io import AudioChunk as JChunk

    from speechflow_torch.data.core.datasample import AudioDataSample as Sample
    from speechflow_torch.data.processors import embeddings as E
    from speechflow_torch.io.audio import AudioChunk

    path = tmp_path / f"{example}.pkl"
    mod = CT if example == "codec" else BT
    args = ["--steps", "2", "--batch", "2", "--platform", "cpu", "--data_root", str(SEGS),
            "--save", str(path)]
    model = mod.main(args + (["--chunk_s", "0.1"] if example == "codec" else []))
    assert path.exists() and not model.training
    wav = AudioChunk(file_path=construct_file_list(SEGS, ext=".wav")[0]).load(sr=24000)
    wav = wav.waveform[:24000]
    if example == "codec":
        ref = JE.codec_features(JSample(audio_chunk=JChunk(data=wav, sr=24000)),
                                model_ckpt=str(path)).ac_feat
        E.set_codec_model(E.make_codec_hook(str(path), device="cpu"))
        try:
            got = E.codec_features(Sample(audio_chunk=AudioChunk(data=wav, sr=24000))).ac_feat
        finally:
            E.set_codec_model(None)
    else:
        ref = JE.voice_biometrics(JSample(audio_chunk=JChunk(data=wav, sr=24000)),
                                  model_ckpt=str(path)).speaker_emb
        E.set_biometric_model(E.make_ecapa_hook(str(path), device="cpu"))
        try:
            got = E.voice_biometrics(Sample(audio_chunk=AudioChunk(data=wav, sr=24000))
                                     ).speaker_emb
        finally:
            E.set_biometric_model(None)
    assert got.shape == ref.shape and got.shape[-1] == 64
    np.testing.assert_allclose(got, ref, atol=1e-4 * max(1.0, np.abs(ref).max()), rtol=0)
