"""Data-parallel GAN training of the vocoder against one process and against
JAX (CPU, two gloo ranks; plain anti-alias on the CPU).

The debug BigVGAN recipe of ``configs/vocoder_bigvgan.yml`` (seeded random
weights, the adversarial terms on from step 0) takes one ``GANTrainer``
optimizer step with ``use_mesh``: SGD at lr 1 (the update is the
accumulated gradient) over 2 micro-batches of 2 SEGS
waveforms accumulated (``test_torch_trainers.py``'s pair), each micro-batch
split over the two ranks. The ranks and the one process run in float64, so a
micro-batch split over the ranks rounds no differently from the whole one; the
discriminators' kinks (leaky ReLUs, hinges) are recorded on the ranks and
replayed in the one process, as ``chip_smoke.py``'s GAN gates pin them. The
STFT loss's spectral convergence is a ratio of the whole batch's norms
(``parallel.distributed.norm_ratio``). Checked: the losses and both models'
updates against the port's one process on the whole micro-batches (1e-6),
and the updates against JAX's ``GANTrainer`` in float32
(``test_torch_trainers.py``'s tolerance).
"""

import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.convert import flatten_nnx, nnx_from_module
from speechflow_torch.models.vocoder import Vocos, VocosParams
from speechflow_torch.models.vocoder.discriminators import VocoderDiscriminator
from speechflow_torch.scripts import train_vocoder
from tests import torch_dp_ranks as R
from tests.test_torch_distributed import EXACT, WORLD, _losses_equal
from tests.test_torch_trainers import UPDATE_TOL, _batches, _pair

torch.set_num_threads(1)
GAN_SGD = dict(method="sgd", lr=1.0, lr_schedule="ConstLR", grad_clip=None,
               betas=(0.0, 0.999), grad_accum=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg, _ = train_vocoder.configs("debug")
    jax_gan, ours = _pair(GAN_SGD)
    micro = [b["waveform"] for b in _batches(2)]  # 2 micro-batches of 2
    per = len(micro[0]) // WORLD
    gan = dict(kind="gan", model_cfg=cfg, loss=dict(cfg["loss"], adv_start_iter=0),
               opt=GAN_SGD, gen_weights=R._weights(ours.generator),
               disc_weights=R._weights(ours.discriminator), dtype="float64",
               batches=[[{"waveform": m[r * per:(r + 1) * per]} for m in micro]
                        for r in range(WORLD)])
    world = R.start_world(WORLD, {"gan": gan}, tmp_path_factory.mktemp("dp_gan"))
    try:  # JAX's steps while the ranks run
        for m in micro:
            jax_gan.training_step({"waveform": m})
    finally:
        ranks = R.join_world(world)
    masks = [np.concatenate(ms) for ms in zip(*(r["gan"]["masks"] for r in ranks))]
    one = R.gan_steps(dict(gan, batches=[[{"waveform": m} for m in micro]], masks=masks), 0)
    jax = {tag: flatten_nnx(nnx.to_pure_dict(nnx.state(mod, nnx.Param)))
           for tag, mod in (("gen", jax_gan.generator), ("disc", jax_gan.discriminator))}
    return dict(ranks=[r["gan"] for r in ranks], one=one, jax=jax, cfg=cfg,
                before={"gen": R._weights(ours.generator),
                        "disc": R._weights(ours.discriminator)})


def _updates_within(got: dict, ref: dict, before: dict, tol: float, what: str) -> None:
    """Every update within ``tol`` of the model's largest update."""
    assert set(got) == set(ref) == set(before)
    scale = max(np.abs(ref[k] - before[k]).max() for k in ref)
    err = max(np.abs((got[k] - before[k]) - (ref[k] - before[k])).max() for k in ref)
    assert 0 < scale and err <= tol * scale, f"{what}: {err} of {scale}"


def test_gan_step_equals_one_process(runs):
    """The ranks' logged losses and both models' updates are one process's on
    the whole micro-batches within 1e-6 (the kinks replayed; the count of
    elements that crossed one is in the message), and both models' weights are
    equal on the two ranks."""
    a, b = runs["ranks"]
    one = runs["one"]
    _losses_equal(a["losses"], one["losses"], EXACT)
    for tag in ("gen", "disc"):
        assert all(np.array_equal(a[tag][k], b[tag][k]) for k in a[tag])
        _updates_within(a[tag], one[tag], runs["before"][tag], EXACT,
                        f"{tag} ({one['flips']} kink elements replayed)")


def test_gan_step_matches_jax(runs):
    """Both models' updates within ``UPDATE_TOL`` of the largest of JAX's."""
    cfg = runs["cfg"]
    for tag, module in (("gen", Vocos(VocosParams.create(cfg["model"]))),
                        ("disc", VocoderDiscriminator(**cfg["discriminator"]))):
        R._load(module, runs["before"][tag], "cpu")
        before = flatten_nnx(nnx_from_module(module))
        R._load(module, runs["ranks"][0][tag], "cpu")
        _updates_within(flatten_nnx(nnx_from_module(module)), runs["jax"][tag], before,
                        UPDATE_TOL, tag)
