"""Prosody losses (counterpart of ``speechflow_tpu/models/prosody/criterion.py``):
cross-entropy on both heads over the words whose target is not ``IGNORE``,
the category head optionally weighted by class, and the equal error rate."""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from speechflow_torch.parallel.distributed import global_count

__all__ = ["ProsodyCriterion", "eer", "IGNORE"]

IGNORE = -1


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position softmax cross-entropy at integer labels (B, T)."""
    return F.cross_entropy(logits.float().transpose(1, 2), labels.long(), reduction="none")


class ProsodyCriterion:
    def __init__(self, binary_scale: float = 1.0, category_scale: float = 1.0,
                 class_weights: tp.Optional[torch.Tensor] = None):
        self.binary_scale = binary_scale
        self.category_scale = category_scale
        self.class_weights = class_weights

    def __call__(self, outputs: tp.Mapping[str, torch.Tensor],
                 targets: tp.Mapping[str, torch.Tensor], step) -> tp.Dict[str, torch.Tensor]:
        losses = {}
        b_tgt = targets["binary"]
        mask = (b_tgt != IGNORE).float()
        ce_b = _ce(outputs["binary"], torch.clamp(b_tgt, min=0))
        losses["binary"] = self.binary_scale * (ce_b * mask).sum() / torch.clamp(
            global_count(mask.sum()), min=1)
        c_tgt = targets["category"]
        cmask = (c_tgt != IGNORE).float()
        ce_c = _ce(outputs["category"], torch.clamp(c_tgt, min=0))
        if self.class_weights is not None:
            w = torch.as_tensor(self.class_weights, device=ce_c.device, dtype=ce_c.dtype)
            ce_c = ce_c * w[torch.clamp(c_tgt, min=0).long()]
        losses["category"] = self.category_scale * (ce_c * cmask).sum() / torch.clamp(
            global_count(cmask.sum()), min=1)
        return losses


def eer(scores, labels) -> float:
    """Equal error rate of binary ``labels`` ranked by ``scores``."""
    scores = np.asarray(scores).ravel()
    labels = np.asarray(labels).ravel()
    order = np.argsort(-scores)
    labels = labels[order]
    pos = labels.sum()
    neg = len(labels) - pos
    if pos == 0 or neg == 0:
        return 0.0
    tpr = np.cumsum(labels) / pos
    fpr = np.cumsum(1 - labels) / neg
    fnr = 1 - tpr
    i = np.argmin(np.abs(fnr - fpr))
    return float((fnr[i] + fpr[i]) / 2)
