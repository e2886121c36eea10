"""speechflow_torch: the PyTorch/CUDA port of speechflow_tpu.

The port mirrors the JAX package's layout module for module
(``speechflow_torch/ops/attention.py`` is the counterpart of
``speechflow_tpu/ops/attention.py``, and so on). It imports ``torch`` and
never ``jax``, ``flax`` or ``speechflow_tpu``; the only bridge between the two
packages is ``speechflow_torch.convert``, which takes plain numpy arrays.

Ported so far: the two serving programs of ``bench.py`` (``serving``: the
flagship CFM-DiT acoustic model with the BigVGAN vocoder, its head folded as
served, and the toy CFM model with the ISTFT vocoder), the STFT / ISTFT and
mel ops, the vocoder's ``mel`` and ``audio`` feature extractors, the vocoder eval
interface (``interface.vocoder_interface``) with the plain-dict half of
checkpoint loading (``training.saver``, ``utils.state_io``), and the TTS eval
interface (``interface.tts_interface``) with the host-side text path it
rebuilds from a checkpoint's payload (``data``: text normalisation, the char
fallback and G2P hooks, linguistic and LM features, SSML, collation, the
pipeline; ``models.g2p``), and GAN training of the vocoder
(``scripts.train_vocoder``: the trainers, optimizer and schedules of
``training``, the discriminators, criteria and metrics of ``models.vocoder``,
the CQT and YIN ops, the audio data path, and checkpoints the interfaces
load). TTS training and the rest of the zoo are not ported yet.

Every TPU kernel on the ported path is a hand-written CUDA kernel for Hopper
(``speechflow_torch/csrc``), built with ``nvcc`` at first use. On a CPU tensor
each kernel wrapper runs its plain PyTorch version instead; on a CUDA tensor
it launches the kernel (the anti-aliased snake's entries through autograd
Functions whose VJPs are PyTorch ops) or raises.

Importing this package loads nothing but itself: the submodules are imported
where they are used.
"""

__version__ = "0.1.0"
