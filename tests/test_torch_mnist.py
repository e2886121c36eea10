"""The MNIST example (``speechflow_torch/examples/mnist/train.py``) against JAX's
(``examples/mnist/train.py``): the same synthetic images and labels; the port's
NCHW LeNet from JAX's NHWC one through ``convert.lenet_state_dict`` (and back
through ``lenet_to_nnx``) gives JAX's logits within 1e-5; one ``Trainer`` step
(adamw at lr 1e-3, the global-norm clip at 1) gives JAX's losses and parameters
within 1e-5; 20 steps on the CPU lower the loss."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax import nnx

from speechflow_torch.convert import lenet_state_dict, lenet_to_nnx
from speechflow_torch.data.collate import ImageCollate
from speechflow_torch.data.core.datasample import ImageDataSample
from speechflow_torch.examples.mnist import train as M
from tests.torch_parity import randomize

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_mnist_example",
                                                  REPO / "examples" / "mnist" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class JaxLeNet(nnx.Module):
    """The JAX example's model (defined inside its ``main``)."""

    def __init__(self, n_classes, rngs):
        self.c1 = nnx.Conv(1, 16, (5, 5), padding="SAME", rngs=rngs)
        self.c2 = nnx.Conv(16, 32, (5, 5), padding="SAME", rngs=rngs)
        self.l1 = nnx.Linear(32 * 7 * 7, 128, rngs=rngs)
        self.l2 = nnx.Linear(128, n_classes, rngs=rngs)

    def __call__(self, inputs):
        x = inputs["image"]
        x = nnx.max_pool(nnx.relu(self.c1(x)), (2, 2), (2, 2))
        x = nnx.max_pool(nnx.relu(self.c2(x)), (2, 2), (2, 2))
        return self.l2(nnx.relu(self.l1(x.reshape(x.shape[0], -1))))


def jax_criterion(logits, targets, step):
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, targets["label"])
    acc = jnp.mean((jnp.argmax(logits, -1) == targets["label"]).astype(jnp.float32))
    return {"ce": jnp.mean(ce), "constant_acc": acc}


def _pair():
    """JAX's LeNet with seeded random weights (biases too) and the port's copy."""
    jm = randomize(JaxLeNet(4, nnx.Rngs(0)), seed=2)
    pm = M.LeNet(4)
    pm.load_state_dict(lenet_state_dict(nnx.to_pure_dict(nnx.state(jm, nnx.Param))))
    return jm, pm


def _batch(n: int = 64):
    images, labels = M.synthetic_shapes()
    idx = np.random.default_rng(0).permutation(len(labels))[:n]
    collate = ImageCollate(label2id={str(i): i for i in range(4)})
    return collate([ImageDataSample(image=images[i][..., None], label=str(labels[i]))
                    for i in idx])


def test_synthetic_data_is_jaxs():
    ours, ref = M.synthetic_shapes(), _jax_example().load_mnist_or_synthetic()
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_lenet_logits_match_jax():
    jm, pm = _pair()
    batch = _batch()
    want = np.asarray(jm({"image": jnp.asarray(batch.image)}))
    got = pm({"image": torch.from_numpy(batch.image)}).detach().numpy()
    assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1.0)
    back = lenet_to_nnx(pm)
    ref = nnx.to_pure_dict(nnx.state(jm, nnx.Param))
    for m in back:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[m][leaf], np.asarray(ref[m][leaf]))


def test_trainer_step_matches_jax():
    from speechflow_tpu.training import OptimizerConfig as JOpt
    from speechflow_tpu.training import Trainer as JTrainer
    from speechflow_tpu.training import TrainerConfig as JCfg

    from speechflow_torch.training.optimizer import OptimizerConfig
    from speechflow_torch.training.trainer import Trainer, TrainerConfig

    jm, pm = _pair()
    batch = _batch()
    jt = JTrainer(jm, jax_criterion, lambda c: ({"image": c.image}, {"label": c.label_id}),
                  JOpt(lr=1e-3), JCfg(max_steps=1))
    pt = Trainer(pm, M.criterion, M.batch_processor, OptimizerConfig(lr=1e-3),
                 TrainerConfig(max_steps=1))
    want = {k: float(v) for k, v in jt.training_step(batch).items()}
    got = {k: float(v) for k, v in pt.training_step(batch).items()}
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL * max(abs(want[k]), 1.0), (k, got[k], want[k])
    ref, ours = nnx.to_pure_dict(nnx.state(jm, nnx.Param)), lenet_to_nnx(pm)
    for m in ref:
        for leaf in ("kernel", "bias"):
            err = np.abs(ours[m][leaf] - np.asarray(ref[m][leaf])).max()
            assert err <= TOL, (m, leaf, err)


def test_twenty_steps_on_the_cpu_lower_the_loss():
    run = M.train(steps=20, batch=64, device="cpu")
    assert run["steps"] == 20 and run["last"]["ce"] < run["first"]["ce"]
    assert np.isfinite(run["ms_step"])
