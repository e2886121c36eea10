"""Training callbacks (counterpart of ``speechflow_tpu/training/callbacks.py``),
callables ``cb(trainer, metrics)`` that ``Trainer.fit`` runs after every step;
both write to the trainer's TensorBoard writer (``tb_dir``) and do nothing
without one.

- ``TTSTrainingVisualizer(get_batch, every)``: every ``every`` steps, the
  model's inference (``training=False``) on a batch from ``get_batch()``: the
  predicted mel, the target mel and the attention (token -> frame map) of its
  first row, as images (``utils/plotting.py``; matplotlib is imported then).
- ``GradNormCallback(every)``: every ``every`` steps, the norm of the change
  of all parameters since its last call (``param_delta_norm``), as the JAX
  callback logs it.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from speechflow_torch.utils.plotting import plot_spectrogram

__all__ = ["TTSTrainingVisualizer", "GradNormCallback"]


class TTSTrainingVisualizer:
    def __init__(self, get_batch: tp.Callable, every: int = 1000):
        self.get_batch = get_batch
        self.every = every

    @torch.no_grad()
    def __call__(self, trainer, metrics: tp.Mapping[str, float]) -> None:
        if trainer._tb is None or trainer.global_step % self.every:
            return
        inputs, targets = trainer.batch_processor(self.get_batch())
        out = trainer.model(inputs.to(trainer.device), training=False)
        step = trainer.global_step
        images = {"pred_mel": out.spectrogram[-1][0].float().cpu().numpy()}
        if targets.mel is not None:
            images["gt_mel"] = targets.mel[0].float().numpy()
        if out.attention is not None:
            images["attention"] = out.attention[0].float().cpu().numpy().T
        for tag, img in images.items():
            trainer._tb.add_image(tag, plot_spectrogram(img), step, dataformats="HWC")


class GradNormCallback:
    def __init__(self, every: int = 100):
        self.every = every
        self._prev: tp.Optional[torch.Tensor] = None

    @torch.no_grad()
    def __call__(self, trainer, metrics) -> None:
        if trainer._tb is None or trainer.global_step % self.every:
            return
        flat = torch.cat([p.detach().float().reshape(-1) for p in trainer.model.parameters()])
        if self._prev is not None and self._prev.shape == flat.shape:
            trainer._tb.add_scalar("param_delta_norm", float(torch.linalg.vector_norm(
                flat - self._prev)), trainer.global_step)
        self._prev = flat
