"""The MOS proxy of the port against the JAX package (f32, CPU): ``degrade`` bit
for bit under the same numpy generator (each kind, and the random kind), the
training batches ``train_mos_proxy`` draws, ``MOSProxy`` on the same weights
(within 1e-5 of the score), ``MOSProxyHook`` (resampling, the too-short
``None``, a JAX ``save_module`` pickle), a few training steps on SEGS, and the
hook in a GAN trainer's validation."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.models.vocoder import mos_proxy as M
from tests.torch_parity import n, port, randomize, t

torch.set_num_threads(1)
SR = 24000
SEGS = Path(__file__).resolve().parent / "data" / "SEGS"


def waves(k: int = 3, length: int = 12000):
    from speechflow_torch.io.audio import AudioChunk

    files = sorted(SEGS.rglob("*.wav"))[:k]
    return [AudioChunk(file_path=f).load(sr=SR).waveform[:length] for f in files]


@pytest.mark.parametrize("kind", [0, 1, 2, 3, None])
def test_degrade_bit_for_bit(kind):
    from speechflow_tpu.models.vocoder import mos_proxy as J

    wav = waves(1)[0]
    for level in (0.0, 0.3, 1.0):
        a = M.degrade(wav, SR, level, np.random.default_rng(5), kind)
        b = J.degrade(wav, SR, level, np.random.default_rng(5), kind)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_training_batches_are_jaxs_draws(monkeypatch):
    """``mos_batch`` draws what the JAX ``train_mos_proxy`` loop draws: its
    batches, recorded from one JAX step, equal the port's from the same seed."""
    from speechflow_tpu.models.vocoder import mos_proxy as J

    ws = waves()
    seen = []

    def record(model, opt, wav, target):
        seen.append((np.asarray(wav), np.asarray(target)))

    monkeypatch.setattr(nnx, "jit", lambda fn: record)
    J.train_mos_proxy(ws, SR, steps=2, batch=3, chunk_s=0.25, seed=4)
    rng = np.random.default_rng(4)
    for wav, target in seen:
        x, y = M.mos_batch(ws, SR, 3, int(0.25 * SR), rng)
        np.testing.assert_array_equal(x, wav)
        np.testing.assert_array_equal(y, target)


def test_mos_proxy_and_hook(tmp_path):
    from speechflow_tpu.models.vocoder import mos_proxy as J
    from speechflow_tpu.utils.state_io import save_module

    p = J.MOSProxyParams(n_mels=16, dim=8, n_layers=2)
    jm = randomize(J.MOSProxy(p, rngs=nnx.Rngs(0)), seed=6)
    tm = port(M.MOSProxy(M.MOSProxyParams(n_mels=16, dim=8, n_layers=2)), jm)
    x = np.stack(waves(2, 6000))
    np.testing.assert_allclose(n(tm(t(x))), np.asarray(jm(jnp.asarray(x))), atol=1e-5)
    ckpt = save_module(jm, p, tmp_path / "mos.pkl")
    hook, jhook = M.MOSProxyHook(str(ckpt), device="cpu"), J.MOSProxyHook(str(ckpt))
    for wav, sr in ((x[0], SR), (x[1][:4000], 16000)):
        got, ref = hook(wav, sr), jhook(wav, sr)
        assert 1.0 <= got <= 5.0 and abs(got - ref) <= 1e-5
    assert hook(x[0][:500], SR) is None and jhook(x[0][:500], SR) is None


def test_train_mos_proxy_runs_and_hooks_into_validation():
    """A few Adam steps on SEGS chunks (finite, in [1, 5]), then the hook as a
    GAN trainer's ``mos_hook``: validation reports ``val/mos``."""
    from speechflow_torch.models.vocoder import Vocos, VocosParams
    from speechflow_torch.models.vocoder.batch_processor import VocoderBatchProcessor
    from speechflow_torch.models.vocoder.criterion import (
        vocoder_disc_criterion,
        vocoder_gen_criterion,
    )
    from speechflow_torch.models.vocoder.discriminators import VocoderDiscriminator
    from speechflow_torch.training.gan_trainer import GANTrainer
    from speechflow_torch.training.trainer import TrainerConfig

    model = M.train_mos_proxy(waves(), SR, steps=3, batch=2, chunk_s=0.25, device="cpu",
                              params=M.MOSProxyParams(n_mels=16, dim=8, n_layers=2))
    score = M.MOSProxyHook(model)(waves(1)[0], SR)
    assert np.isfinite(score) and 1.0 <= score <= 5.0
    gen = Vocos(VocosParams.create(dict(n_fft=64, hop_length=16, n_mels=12, dim=16,
                                        n_layers=1)))
    gan = GANTrainer(gen, VocoderDiscriminator(periods=[2], resolutions=[[128, 32]],
                                               channels=4),
                     vocoder_gen_criterion(n_mels=12), vocoder_disc_criterion(),
                     VocoderBatchProcessor(), config=TrainerConfig(val_batches=1),
                     mos_hook=M.MOSProxyHook(model))
    metrics = gan.validate([{"waveform": np.stack(waves(2, 4096))}])
    assert 1.0 <= metrics["val/mos"] <= 5.0


def test_train_vocoder_reads_no_gan_mos_ckpt(tmp_path, monkeypatch):
    """A fault of the port, repaired: ``train_vocoder`` raised on ``gan.mos_ckpt``,
    which the JAX script accepts and never reads (its MOS hook comes only through
    ``GANTrainer(mos_hook=...)``). Now the key is accepted and read nowhere: the
    trainer gets no hook, even for a path that does not exist."""
    from speechflow_torch.scripts import train_vocoder as TV
    from speechflow_torch.scripts.common import experiment_saver
    from speechflow_torch.training.gan_trainer import GANTrainer

    seen = {}

    def fit(self, *args, **kwargs):
        seen["mos_hook"] = self.mos_hook
        return {}

    monkeypatch.setattr(GANTrainer, "fit", fit)
    model_cfg, data_cfg = TV.configs("debug", data_root=SEGS)
    model_cfg.setdefault("gan", {})["mos_ckpt"] = str(tmp_path / "missing.pkl")
    TV.train(model_cfg, data_cfg, experiment_saver(model_cfg, data_cfg, tmp_path),
             device="cpu")
    assert seen == {"mos_hook": None}
