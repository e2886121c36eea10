"""E2E GAN-TTS of the port against the JAX package (f32, CPU): ``TTSFeatures``
(the acoustic model as the vocoder's feature extractor) in its training and
inference modes, with its ``ft_losses`` and the frame-level pitch it hands an NSF
head; ``Vocos`` with the ``tts`` extractor and the NSF head; one GAN step of the
E2E generator through both packages' trainers; the batch processor; and the
reference's step-0 TTS criterion, kept.

Narrow widths (the recipe's transformer encoder and wrapper decoder), dropout 0
on both sides, JAX's sine-source draws injected. Tolerance: outputs within
1e-4 of the reference's largest magnitude; losses within 1e-4 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.models.vocoder import Vocos, VocosParams
from tests.torch_parity import (
    jax_tts_input,
    n,
    no_dropout,
    port,
    randomize,
    t,
    torch_tts_input,
    tts_params,
)

torch.set_num_threads(1)
TOL_REL = 1e-4
HOP = 16
TTS = tts_params(decoder_type="wrapper", use_ling_feat=False, use_lm_feat=False,
                 use_xpbert_feat=False, n_mels=12, max_output_length=64)


def close(got, ref, tol: float = TOL_REL):
    got, ref = n(got), n(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= tol * scale, (np.abs(got - ref).max(), scale)


def arrays(rng, teacher: bool = True) -> dict:
    """A batch of 2 (ragged): tokens, speakers, languages, and with ``teacher``
    the teacher durations, mel and token pitch/energy targets."""
    b, n_tok = 2, 6
    lengths = np.asarray([6, 4], np.int32)
    valid = np.arange(n_tok)[None] < lengths[:, None]
    out = dict(transcription=np.where(valid, rng.integers(5, 20, (b, n_tok)), 0).astype(np.int32),
               transcription_lengths=lengths,
               speaker_id=rng.integers(0, 3, (b,)).astype(np.int32),
               lang_id=rng.integers(0, 2, (b,)).astype(np.int32))
    if teacher:
        dur = np.where(valid, rng.integers(2, 4, (b, n_tok)), 0).astype(np.float32)
        frames = dur.sum(1).astype(np.int32)
        out.update(durations=dur, mel_lengths=frames,
                   mel=rng.normal(size=(b, int(frames.max()), 12)).astype(np.float32),
                   aggregate_pitch=np.where(valid, rng.uniform(100, 250, (b, n_tok)), 0)
                   .astype(np.float32),
                   aggregate_energy=np.where(valid, rng.uniform(0, 2, (b, n_tok)), 0)
                   .astype(np.float32))
    return out


def models(head: str = "nsf_hifigan", seed: int = 3, rates=(4, 2, 2)):
    """The JAX and the port E2E generator with the same weights, dropout 0 (hop
    = prod(rates))."""
    from speechflow_tpu.models.vocoder import Vocos as J
    from speechflow_tpu.models.vocoder import VocosParams as JP

    params = dict(sample_rate=24000, n_fft=64, hop_length=int(np.prod(rates)), n_mels=12,
                  feature_extractor="tts", tts_params=TTS, backbone="vocos", head=head,
                  dim=16, n_layers=1, upsample_rates=list(rates), upsample_channels=16,
                  style_dim=6, n_harmonics=4)
    jm = randomize(J(JP.create(params), rngs=nnx.Rngs(0)), seed=seed)
    tm = port(Vocos(VocosParams.create(params)), jm)
    no_dropout(jm, tm)
    return jm, tm


def sine_draws(jax_model, b: int, s: int):
    sg = nnx.clone(jax_model).head.sine_gen
    key = sg.rngs.params()
    return (t(jax.random.normal(key, (b, s, sg.n_harmonics))),
            t(jax.random.normal(key, (b, s, 1))))


@pytest.mark.parametrize("training", [True, False])
def test_tts_features(rng, training):
    """The postnet mel, ``ft_losses`` (the TTS criterion at step 0, with ``ft_``
    names; none in inference) and the frame pitch (token pitch through the
    regulator's attention)."""
    jm, tm = models()
    a = arrays(rng, teacher=training)
    ref = jm.feature_extractor({"tts_inputs": jax_tts_input(a)})
    got = tm.feature_extractor({"tts_inputs": torch_tts_input(a)})
    close(got[0], ref[0])
    assert set(got[1]) == set(ref[1])
    assert bool(got[1]) == training and all(k.startswith("ft_") for k in got[1])
    for k in ref[1]:
        np.testing.assert_allclose(float(got[1][k].detach()), float(ref[1][k]), rtol=1e-4,
                                   err_msg=k)
    assert set(got[2]) == set(ref[2]) == {"pitch"}
    close(got[2]["pitch"], ref[2]["pitch"])


@pytest.mark.parametrize("head", ["nsf_hifigan", "snake_upsample"])
def test_e2e_generator(rng, head):
    """Text (with teacher targets) -> waveform and ft_losses through ``Vocos``:
    the NSF head driven by the predicted pitch (E2E recipe), or the BigVGAN head
    (the ``_ft`` recipe)."""
    jm, tm = models(head)
    a = arrays(rng)
    frames = a["mel"].shape[1]
    draws = sine_draws(jm, 2, frames * HOP) if head.startswith("nsf") else None
    wav_ref, ft_ref = jm({"tts_inputs": jax_tts_input(a)})
    wav, ft = tm({"tts_inputs": torch_tts_input(a)}, sine_noise=draws)
    assert wav.shape == (2, (frames - 1) * HOP)
    close(wav, wav_ref)
    assert set(ft) == set(ft_ref)


def test_e2e_step0_criterion_is_kept(rng, monkeypatch):
    """A fault of the reference, kept: the E2E extractor calls the TTS criterion
    at step 0 whatever the trainer's step, so a loss gated to begin later
    (``begin_iter``) never starts, and anneals stay at their first value."""
    from speechflow_torch.models.tts import TTSCriterion
    from speechflow_tpu.models.tts import TTSCriterion as JCrit

    steps = {"port": [], "jax": []}
    real_t, real_j = TTSCriterion.__call__, JCrit.__call__

    def rec_t(self, out, tgt, step):
        steps["port"].append(int(step))
        return real_t(self, out, tgt, step)

    def rec_j(self, out, tgt, step):
        steps["jax"].append(int(step))
        return real_j(self, out, tgt, step)

    monkeypatch.setattr(TTSCriterion, "__call__", rec_t)
    monkeypatch.setattr(JCrit, "__call__", rec_j)
    jm, tm = models()
    a = arrays(rng)
    jm.feature_extractor({"tts_inputs": jax_tts_input(a)})
    tm.feature_extractor({"tts_inputs": torch_tts_input(a)})
    assert steps == {"port": [0], "jax": [0]}


def test_e2e_batch_processor():
    from speechflow_torch.data.collate import CollatedTTS
    from speechflow_torch.models.tts.batch_processor import TTSBatchProcessor
    from speechflow_torch.models.vocoder.tts_features import E2EBatchProcessor

    c = CollatedTTS(speaker_id=np.asarray([0, 1], np.int32),
                    transcription=np.ones((2, 4), np.int32),
                    transcription_lengths=np.asarray([4, 3], np.int32),
                    waveform=np.zeros((2, 64), np.float32),
                    speaker_emb=np.ones((2, 3), np.float32))
    inputs, targets = E2EBatchProcessor()(c)
    ref, _ = TTSBatchProcessor()(c)
    assert set(inputs) == {"tts_inputs", "waveform", "speaker_emb"}
    for f in dataclasses.fields(ref):
        a, b = getattr(inputs["tts_inputs"], f.name), getattr(ref, f.name)
        assert (a is None and b is None) or (a == b if isinstance(b, int)
                                             else torch.equal(a, b)), f.name
    assert targets["waveform"] is inputs["waveform"] and inputs["waveform"].shape == (2, 64)


def test_e2e_gan_step_matches_jax(rng):
    """One GAN step of the E2E generator (NSF head) through the JAX ``GANTrainer``
    and the port's, from the same weights and batch (SGD at lr 1, the adversarial
    terms on): every loss, the generator's ft_ terms included, and the
    generator's update (within 1e-3 of its largest element)."""
    from speechflow_torch.convert import flatten_nnx, nnx_from_module
    from speechflow_torch.models.vocoder.criterion import (
        vocoder_disc_criterion,
        vocoder_gen_criterion,
    )
    from speechflow_torch.models.vocoder.discriminators import VocoderDiscriminator
    from speechflow_torch.training.gan_trainer import GANTrainer
    from speechflow_torch.training.optimizer import OptimizerConfig
    from speechflow_torch.training.trainer import TrainerConfig
    from speechflow_tpu.models.vocoder.criterion import (
        vocoder_disc_criterion as jdc,
        vocoder_gen_criterion as jgc,
    )
    from speechflow_tpu.models.vocoder.discriminators import VocoderDiscriminator as JD
    from speechflow_tpu.training import GANTrainer as JGAN
    from speechflow_tpu.training.optimizer import OptimizerConfig as JOpt
    from speechflow_tpu.training.trainer import TrainerConfig as JCfg

    hop = 128  # the mel loss's 1024-point STFT needs more than 512 samples
    jm, tm = models(rates=(8, 4, 4))
    disc_kw = dict(periods=[2, 3], resolutions=[[128, 32]], channels=4)
    jd = randomize(JD(**disc_kw, rngs=nnx.Rngs(1)), seed=4)
    td = port(VocoderDiscriminator(**disc_kw), jd)
    a = arrays(rng)
    frames = a["mel"].shape[1]
    wav = (0.3 * rng.normal(size=(2, frames * hop))).astype(np.float32)
    opt = dict(method="sgd", lr=1.0, lr_schedule="ConstLR", grad_clip=None,
               betas=(0.0, 0.999))
    loss = dict(n_mels=12, adv_start_iter=0)
    draws = sine_draws(jm, 2, frames * hop)

    def jbp(batch):
        return {"tts_inputs": jax_tts_input(a), "waveform": jnp.asarray(wav)}, \
            {"waveform": jnp.asarray(wav)}

    def tbp(batch):
        return {"tts_inputs": torch_tts_input(a), "waveform": t(wav)}, {"waveform": t(wav)}

    jgan = JGAN(jm, jd, jgc(**loss), jdc(), jbp, gen_optimizer=JOpt.from_config(opt),
                disc_optimizer=JOpt.from_config(opt), config=JCfg(max_steps=10))
    ours = GANTrainer(tm, td, vocoder_gen_criterion(**loss), vocoder_disc_criterion(), tbp,
                      gen_optimizer=OptimizerConfig.from_config(opt),
                      disc_optimizer=OptimizerConfig.from_config(opt),
                      config=TrainerConfig(max_steps=10))
    tm.head.sine_gen.draw = lambda *args, **kw: draws
    before = flatten_nnx(nnx_from_module(tm))
    jl, tl = jgan.training_step(None), ours.training_step(None)
    assert set(jl) == set(tl) and any(k.startswith("gen/ft_") for k in tl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    got = flatten_nnx(nnx_from_module(tm))
    ref = flatten_nnx(nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
    scale = max(np.abs(ref[k] - before[k]).max() for k in ref)
    err = max(np.abs((got[k] - before[k]) - (ref[k] - before[k])).max() for k in ref)
    assert 0 < scale and err <= 1e-3 * scale, (err, scale)
