"""Seeding (counterpart of ``speechflow_tpu/utils/seed.py``): ``set_seed`` seeds
Python's and numpy's generators as JAX's does, and torch's (the port draws its
randomness from torch generators where JAX takes a key, so it has no ``jax_key``)."""

from __future__ import annotations

import random

import numpy as np

__all__ = ["set_seed"]


def set_seed(seed: int = 0) -> None:
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
