"""The smallest whole use of the stack (counterpart of ``examples/mnist/train.py``):
``ImageDataSample`` -> ``RandomSampler`` -> ``ImageCollate`` -> a LeNet -> the
``Trainer`` (adamw at lr 1e-3), cross-entropy with the batch accuracy logged.

The data is the synthetic set JAX's example builds without MNIST's files (2048
28×28 images of four shapes in noise, from ``default_rng(0)``). ``main`` fails
unless the last batch's accuracy is above 0.8, as JAX's example does.

    python -m speechflow_torch.examples.mnist.train [--steps 200] [--batch 64]
    python -m speechflow_torch.examples.mnist.train --platform cpu

It trains on the GPU unless ``--platform cpu``. The LeNet is NCHW; JAX's is NHWC,
so ``convert.lenet_state_dict`` permutes its weights (``l1``'s rows from HWC to CHW
order).
"""

from __future__ import annotations

import argparse
import time
import typing as tp

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["LeNet", "synthetic_shapes", "criterion", "batch_processor", "train", "main"]


def synthetic_shapes(n: int = 2048) -> tp.Tuple[np.ndarray, np.ndarray]:
    """(n, 28, 28) float32 images and (n,) int32 labels: a horizontal bar, a vertical
    bar, a diagonal or a disk (label i % 4) on N(0, 0.1) noise."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:28, :28]
    images, labels = [], []
    for i in range(n):
        lab = i % 4
        img = rng.normal(0, 0.1, (28, 28)).astype(np.float32)
        if lab == 0:
            img[10:18, 4:24] += 1.0                               # a horizontal bar
        elif lab == 1:
            img[4:24, 10:18] += 1.0                               # a vertical bar
        elif lab == 2:
            img[6:22, 6:22] += np.eye(16)                         # a diagonal
        else:
            img[((yy - 14) ** 2 + (xx - 14) ** 2) < 64] += 1.0    # a disk
        images.append(img)
        labels.append(lab)
    return np.stack(images), np.asarray(labels, np.int32)


class LeNet(nn.Module):
    """5×5 convs of 16 and 32 channels (SAME padding), each ReLU then 2×2 max
    pooling, a 1568 -> 128 ReLU layer and the classes' logits; ``image`` is
    (B, 28, 28, 1), as ``ImageCollate`` stacks it."""

    def __init__(self, n_classes: int):
        super().__init__()
        self.c1 = nn.Conv2d(1, 16, 5, padding=2)
        self.c2 = nn.Conv2d(16, 32, 5, padding=2)
        self.l1 = nn.Linear(32 * 7 * 7, 128)
        self.l2 = nn.Linear(128, n_classes)

    def forward(self, inputs: tp.Mapping[str, torch.Tensor]) -> torch.Tensor:
        x = inputs["image"].permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.c1(x)), 2)
        x = F.max_pool2d(F.relu(self.c2(x)), 2)
        return self.l2(F.relu(self.l1(x.flatten(1))))


def criterion(logits: torch.Tensor, targets: tp.Mapping[str, torch.Tensor], step: int
              ) -> tp.Dict[str, torch.Tensor]:
    label = targets["label"].long()
    acc = (logits.argmax(-1) == label).float().mean()
    return {"ce": F.cross_entropy(logits, label), "constant_acc": acc}


def batch_processor(collated) -> tuple:
    return {"image": collated.image}, {"label": collated.label_id}


def train(steps: int = 200, batch: int = 64, device: tp.Union[str, torch.device, None] = None,
          seed: int = 0) -> dict:
    """Train the LeNet ``steps`` steps; returns the first and last step's losses
    (``first``, ``last``: name -> float) and the median ms of a step after the
    first (the device synchronised)."""
    from speechflow_torch.data.collate import ImageCollate
    from speechflow_torch.data.core.datasample import ImageDataSample
    from speechflow_torch.data.samplers import RandomSampler
    from speechflow_torch.models.layers import flax_init_
    from speechflow_torch.training.optimizer import OptimizerConfig
    from speechflow_torch.training.trainer import Trainer, TrainerConfig
    from speechflow_torch.utils.device import resolve_device

    dev = resolve_device(device)
    images, labels = synthetic_shapes()
    n_classes = int(labels.max()) + 1
    dataset = [ImageDataSample(image=img[..., None], label=str(lab), index=i)
               for i, (img, lab) in enumerate(zip(images, labels))]
    sampler = RandomSampler().set_dataset(dataset)
    collate = ImageCollate(label2id={str(i): i for i in range(n_classes)})

    torch.manual_seed(seed)
    model = flax_init_(LeNet(n_classes)).to(dev)
    trainer = Trainer(model, criterion, batch_processor, OptimizerConfig(lr=1e-3),
                      TrainerConfig(max_steps=steps, log_every=50))
    times, first, last = [], None, None
    for _ in range(steps):
        samples, _ = sampler.sampling(batch)
        t0 = time.perf_counter()
        out = trainer.training_step(collate(samples))
        last = {k: float(v) for k, v in out.items()}  # fetching the losses synchronises
        times.append(time.perf_counter() - t0)
        first = first or last
    return {"first": first, "last": last, "steps": steps,
            "ms_step": 1e3 * float(np.median(times[1:] or times)), "model": model}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--platform", default=None, help="cpu, or the GPU when absent")
    args = p.parse_args(argv)
    run = train(args.steps, args.batch, args.platform)
    first, last = run["first"], run["last"]
    print(f"ce: {first['ce']:.3f} -> {last['ce']:.3f}; accuracy: {last['constant_acc']:.3f}; "
          f"{run['ms_step']:.3f} ms a step")
    if not last["constant_acc"] > 0.8:
        raise RuntimeError(f"the example failed to learn: accuracy {last['constant_acc']}")
    return run


if __name__ == "__main__":
    main()
