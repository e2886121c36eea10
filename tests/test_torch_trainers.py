"""The port's trainers against the JAX package's, from the same weights and
batches (f32, CPU): GAN steps of the flagship vocoder recipe at
``configs/vocoder_bigvgan.yml`` debug dims (sub-band CQT discriminator on,
the adversarial terms on from step 0) with its optimizer (AdamW on
WarmupCosine, clip 1.0), a ``grad_accum`` 2 pair, and ``Trainer`` steps on a
tiny model."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.convert import flatten_nnx, nnx_from_module
from speechflow_torch.models.vocoder import Vocos, VocosParams
from speechflow_torch.models.vocoder.batch_processor import VocoderBatchProcessor
from speechflow_torch.models.vocoder.criterion import (
    vocoder_disc_criterion,
    vocoder_gen_criterion,
)
from speechflow_torch.models.vocoder.discriminators import VocoderDiscriminator
from speechflow_torch.scripts.train_vocoder import configs
from speechflow_torch.training.gan_trainer import GANTrainer
from speechflow_torch.training.optimizer import OptimizerConfig
from speechflow_torch.training.trainer import Trainer, TrainerConfig
from tests.torch_parity import port, randomize

torch.set_num_threads(1)
LOSS_RTOL = 1e-4   # losses of the whole f32 recipe (STFT log-magnitudes, hinge, FM)
# Updates of an SGD step (lr 1: the negated gradients): within 1e-4 of the model's largest
# update. Per tensor the error can look larger: a weight whose gradient is a difference of
# two near-equal sums (the discriminator's post convs: fake minus real) carries the
# rounding of the sums (measured 2.6e-5 of the model's scale, both models).
UPDATE_TOL = 1e-4


def _weights(module) -> dict:
    return flatten_nnx(nnx_from_module(module))


def _jax_weights(module) -> dict:
    return flatten_nnx(nnx.to_pure_dict(nnx.state(module, nnx.Param)))


def _updates_agree(got: dict, ref: dict, before: dict, what: str) -> None:
    assert set(got) == set(ref) == set(before)
    scale = max(np.abs(ref[k] - before[k]).max() for k in ref)
    err = max(np.abs((got[k] - before[k]) - (ref[k] - before[k])).max() for k in ref)
    assert 0 < scale and err <= UPDATE_TOL * scale, f"{what}: {err} of {scale}"


def _within_adam_step(got: dict, ref: dict, lr: float, what: str) -> None:
    """Adam moves a weight by ~lr·sign(g) in its first steps, whatever |g|: where a
    gradient is near 0 or near Adam's eps the two sides may step apart, but never by
    more than two steps."""
    assert set(got) == set(ref)
    for k in ref:
        assert np.abs(got[k] - ref[k]).max() <= 2 * lr, f"{what}.{k}"


def _batches(n: int, length: int = 8448):
    from pathlib import Path

    from speechflow_torch.io.audio import AudioChunk

    files = sorted(Path(__file__).parent.joinpath("data", "SEGS").rglob("*.wav"))
    wavs = [AudioChunk(file_path=f).load(sr=24000).waveform for f in files[:2 * n]]
    return [{"waveform": np.stack([w[24000:24000 + length] for w in wavs[2 * i:2 * i + 2]])
             .astype(np.float32)} for i in range(n)]


def _pair(opt: dict):
    """The JAX and the port GAN trainer of the debug recipe with the same weights."""
    from speechflow_tpu.models.vocoder import Vocos as JVocos
    from speechflow_tpu.models.vocoder import VocosParams as JParams
    from speechflow_tpu.models.vocoder import VocoderBatchProcessor as JBP
    from speechflow_tpu.models.vocoder.criterion import (
        vocoder_disc_criterion as jdc,
        vocoder_gen_criterion as jgc,
    )
    from speechflow_tpu.models.vocoder.discriminators import VocoderDiscriminator as JD
    from speechflow_tpu.training import GANTrainer as JGAN
    from speechflow_tpu.training.optimizer import OptimizerConfig as JOpt
    from speechflow_tpu.training.trainer import TrainerConfig as JCfg

    model_cfg, _ = configs("debug")
    loss = dict(model_cfg["loss"], adv_start_iter=0)
    jg = randomize(JVocos(JParams.create(model_cfg["model"]), rngs=nnx.Rngs(0)), seed=3)
    jd = randomize(JD(**model_cfg["discriminator"], rngs=nnx.Rngs(1)), seed=4)
    tg = port(Vocos(VocosParams.create(model_cfg["model"])), jg)
    td = port(VocoderDiscriminator(**model_cfg["discriminator"]), jd)
    n_mels = model_cfg["model"]["n_mels"]
    jax_gan = JGAN(jg, jd, jgc(n_mels=n_mels, **loss), jdc(), JBP(),
                   gen_optimizer=JOpt.from_config(opt), disc_optimizer=JOpt.from_config(opt),
                   config=JCfg(max_steps=100))
    ours = GANTrainer(tg, td, vocoder_gen_criterion(n_mels=n_mels, **loss),
                      vocoder_disc_criterion(), VocoderBatchProcessor(),
                      gen_optimizer=OptimizerConfig.from_config(opt),
                      disc_optimizer=OptimizerConfig.from_config(opt),
                      config=TrainerConfig(max_steps=100))
    return jax_gan, ours


def _steps(jax_gan, ours, batches) -> None:
    """Micro-batches through both trainers; their losses agree."""
    for batch in batches:
        jm, tm = jax_gan.training_step(batch), ours.training_step(batch)
        assert set(jm) == set(tm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=k)


def _models(gan):
    return (("generator", gan.generator), ("discriminator", gan.discriminator))


def test_gan_steps_of_the_recipe_match_jax():
    """Two micro-batches of the debug recipe (AdamW, WarmupCosine, clip 1.0,
    grad_accum 1): the first optimizer step runs at the schedule's lr of 0, the
    second moves both models."""
    jax_gan, ours = _pair(configs("debug")[0]["optimizer"])
    _steps(jax_gan, ours, _batches(2))
    assert ours.gen_opt.count == 2 and ours.disc_opt.count == 2
    for (tag, tm), (_, jm) in zip(_models(ours), _models(jax_gan)):
        _within_adam_step(_weights(tm), _jax_weights(jm), ours.gen_opt.schedule(1), tag)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_gan_sgd_steps_match_jax(grad_accum):
    """One GAN step with SGD at lr 1 (the update is the gradient, averaged over a
    ``grad_accum`` 2 pair): both models' updates agree with JAX's; with
    accumulation nothing moves after the first micro-batch."""
    opt = dict(method="sgd", lr=1.0, lr_schedule="ConstLR", grad_clip=None,
               betas=(0.0, 0.999), grad_accum=grad_accum)
    jax_gan, ours = _pair(opt)
    before = {tag: _weights(m) for tag, m in _models(ours)}
    batches = _batches(grad_accum)
    _steps(jax_gan, ours, batches[:1])
    if grad_accum == 2:
        for tag, m in _models(ours):
            assert all(np.array_equal(v, before[tag][k]) for k, v in _weights(m).items())
        _steps(jax_gan, ours, batches[1:])
    for (tag, tm), (_, jm) in zip(_models(ours), _models(jax_gan)):
        _updates_agree(_weights(tm), _jax_weights(jm), before[tag], tag)


class TinyModel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.l1 = torch.nn.Linear(8, 32)
        self.l2 = torch.nn.Linear(32, 4)

    def forward(self, inputs):
        return self.l2(torch.relu(self.l1(inputs["x"])))


def test_trainer_steps_match_jax():
    """Three steps of the generic ``Trainer`` (AdamW, clip 1.0; a ``constant``
    loss logged, not summed)."""
    from speechflow_tpu.training import OptimizerConfig as JOpt
    from speechflow_tpu.training import Trainer as JTrainer
    from speechflow_tpu.training import TrainerConfig as JCfg
    from tests.test_training import TinyModel as JTiny

    jm = randomize(JTiny(rngs=nnx.Rngs(0)), seed=5)
    tm = port(TinyModel(), jm)

    def jcrit(out, tgt, step):
        return {"mse": jnp.mean((out - tgt["y"]) ** 2), "constant_probe": jnp.mean(out)}

    def tcrit(out, tgt, step):
        return {"mse": torch.mean((out - tgt["y"]) ** 2), "constant_probe": torch.mean(out)}

    def bp(batch):
        return {"x": batch["x"]}, {"y": batch["y"]}

    jt = JTrainer(jm, jcrit, bp, JOpt(lr=1e-2), JCfg(max_steps=10))
    tt = Trainer(tm, tcrit, bp, OptimizerConfig(lr=1e-2), TrainerConfig(max_steps=10))
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.normal(size=(4, 8)).astype(np.float32)
        batch = {"x": x, "y": (x[:, :4] * 2.0).astype(np.float32)}
        a, b = jt.training_step(batch), tt.training_step(batch)
        for k in a:
            np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=1e-6, atol=1e-7)
        assert float(b["total_loss"]) == pytest.approx(float(b["mse"]))
    _within_adam_step(_weights(tm), _jax_weights(jm), 1e-2, "tiny")
    ref = _jax_weights(jm)  # this model has no gradient near 0: it agrees far closer
    assert max(np.abs(v - ref[k]).max() for k, v in _weights(tm).items()) <= 1e-5


def test_trainers_refuse_the_mesh():
    """``use_mesh`` in one process (no process group) is a one-rank mesh: the
    trainer no longer refuses it, and its steps are the plain trainer's, bit for
    bit (the data-parallel steps are in ``test_torch_distributed.py``)."""
    def crit(out, tgt, step):
        return {"mse": torch.mean((out - tgt["y"]) ** 2)}

    def bp(batch):
        return {"x": batch["x"]}, {"y": batch["y"]}

    torch.manual_seed(0)
    a = TinyModel()
    b = TinyModel()
    b.load_state_dict(a.state_dict())
    plain = Trainer(a, crit, bp, OptimizerConfig(lr=1e-2), TrainerConfig(max_steps=3))
    mesh = Trainer(b, crit, bp, OptimizerConfig(lr=1e-2), TrainerConfig(max_steps=3,
                                                                         use_mesh=True))
    assert mesh.mesh is not None and mesh.mesh.size == 1 and plain.mesh is None
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.normal(size=(4, 8)).astype(np.float32)
        batch = {"x": x, "y": (x[:, :4] * 2.0).astype(np.float32)}
        assert float(plain.training_step(batch)["mse"]) == float(mesh.training_step(batch)["mse"])
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n


def test_mixed_precision_gan_step():
    """bf16 autocast over the generator and discriminator calls (CPU autocast):
    finite float32 losses, float32 master weights that move on the second
    step, and the generator output cast to float32 for the criteria."""
    _, ours = _pair(configs("debug")[0]["optimizer"])
    ours.cfg.mixed_precision = True
    seen = {}
    real_disc = ours._disc

    def disc(wav):
        seen["disc_input"] = wav.dtype
        return real_disc(wav)

    ours._disc = disc
    def conv_dtype(mod, args, out):
        seen["conv_output"] = out.dtype

    ours.generator.head.pre.register_forward_hook(conv_dtype)
    before = [p.detach().clone() for p in ours.generator.parameters()]
    for batch in _batches(2):
        m = ours.training_step(batch)
        assert all(torch.isfinite(v) and v.dtype == torch.float32 for v in m.values())
    assert seen["disc_input"] == torch.float32 and seen["conv_output"] == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in ours.generator.parameters())
    assert not all(torch.equal(p, q) for p, q in zip(ours.generator.parameters(), before))
