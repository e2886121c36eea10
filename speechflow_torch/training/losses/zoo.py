"""The losses of the acoustic model's criterion (counterpart of
``SpectralLoss``, ``GateLoss`` and ``RegressionLoss`` in
``speechflow_tpu/training/losses/zoo.py``): length-masked means in float32;
and ``CTCLoss``, the CTC recognizer's. The rest of the JAX zoo comes with the
models that use it."""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from speechflow_torch.parallel.distributed import global_count
from speechflow_torch.training.losses.base import BaseLoss
from speechflow_torch.utils.masks import sequence_mask

__all__ = ["SpectralLoss", "GateLoss", "RegressionLoss"]


def _masked_mean(err: torch.Tensor, lengths: tp.Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of ``err`` (B, T, ...) over the first ``lengths`` positions of each row."""
    if lengths is None:
        return err.mean()
    mask = sequence_mask(lengths, err.shape[1])
    while mask.ndim < err.ndim:
        mask = mask[..., None]
    m = mask.to(err.dtype)
    return (err * m).sum() / torch.clamp(global_count(m.expand_as(err).sum()), min=1e-8)


class SpectralLoss(BaseLoss):
    """L1 / L2 / Huber over a spectrogram, or the mean of its stacked stages'
    errors (S, B, T, n_mels), with length masking."""

    def __init__(self, kind: str = "l1", **kwargs):
        super().__init__(**kwargs)
        if kind not in ("l1", "l2", "huber"):
            raise ValueError(kind)
        self.kind = kind

    def compute(self, output: torch.Tensor, target: torch.Tensor,
                lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        if output.ndim == target.ndim + 1:  # stacked per-stage predictions
            err = torch.stack([self._err(o, target) for o in output]).mean(0)
        else:
            err = self._err(output, target)
        return _masked_mean(err, lengths)

    def _err(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == "l1":
            return (a - b).abs()
        if self.kind == "l2":
            return (a - b) ** 2
        return F.huber_loss(a, b, reduction="none", delta=1.0)


class GateLoss(BaseLoss):
    """BCE with logits on the stop token."""

    def __init__(self, pos_weight: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.pos_weight = pos_weight

    def compute(self, output: torch.Tensor, target: torch.Tensor,
                lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        err = -(self.pos_weight * target * F.logsigmoid(output)
                + (1.0 - target) * F.logsigmoid(-output))
        return _masked_mean(err, lengths)


class RegressionLoss(BaseLoss):
    """MSE or L1 of a variance predictor; ``log_domain`` takes the target's
    log(1 + max(target, 0))."""

    def __init__(self, kind: str = "l2", log_domain: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.kind = kind
        self.log_domain = log_domain

    def compute(self, output: torch.Tensor, target: torch.Tensor,
                lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.log_domain:
            target = torch.log1p(torch.clamp(target, min=0.0))
        err = (output - target).abs() if self.kind == "l1" else (output - target) ** 2
        return _masked_mean(err, lengths)


class CTCLoss(BaseLoss):
    """CTC over (B, T, V) logits and (B, U) labels (``optax.ctc_loss``'s
    semantics): each sequence's negative log-likelihood over its label count
    (at least 1), then the batch mean. ``lengths`` bound the valid frames (all
    when None); ``target_lengths`` the valid labels (when None, the labels
    equal to ``blank_id`` are padding, which must trail)."""

    def __init__(self, blank_id: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.blank_id = blank_id

    def compute(self, output: torch.Tensor, target: torch.Tensor,
                lengths: tp.Optional[torch.Tensor] = None,
                target_lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = output.shape
        if lengths is None:
            lengths = torch.full((b,), t, dtype=torch.long, device=output.device)
        if target_lengths is None:
            target_lengths = (target != self.blank_id).sum(-1)
        logp = F.log_softmax(output.float(), dim=-1).transpose(0, 1)
        per_seq = F.ctc_loss(logp, target.long(), lengths.long(), target_lengths.long(),
                             blank=self.blank_id, reduction="none")
        per_seq = per_seq / torch.clamp(target_lengths.to(per_seq.dtype), min=1.0)
        return per_seq.sum() / global_count(per_seq.new_tensor(float(b)))
