"""speechflow_torch: the PyTorch/CUDA port of speechflow_tpu.

The port mirrors the JAX package's layout module for module
(``speechflow_torch/ops/attention.py`` is the counterpart of
``speechflow_tpu/ops/attention.py``, and so on). It imports ``torch`` and
never ``jax``, ``flax`` or ``speechflow_tpu``; the only bridge between the two
packages is ``speechflow_torch.convert``, which takes plain numpy arrays.

Every TPU kernel on the ported path is a hand-written CUDA kernel for Hopper
(``speechflow_torch/csrc``), built with ``nvcc`` at first use. On a CPU tensor
each kernel wrapper runs its plain PyTorch version instead.

Importing this package loads nothing but itself: the submodules are imported
where they are used.
"""

__version__ = "0.1.0"
