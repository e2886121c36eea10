"""The aligner's losses (counterpart of ``speechflow_tpu/models/aligner/criterion.py``):
the flow's negative log-likelihood under the hard MAS path, and the duration
regression in the log(1 + d) domain against the path's durations."""

from __future__ import annotations

import math
import typing as tp

import torch

from speechflow_torch.parallel.distributed import global_count
from speechflow_torch.utils.masks import sequence_mask

__all__ = ["AlignerCriterion"]


class AlignerCriterion:
    def __init__(self, duration_scale: float = 1.0):
        self.duration_scale = duration_scale

    def __call__(self, outputs: dict, targets, step) -> tp.Dict[str, torch.Tensor]:
        z, logdet = outputs["z"], outputs["logdet"]
        mu_t, logstd_t = outputs["mu_t"], outputs["logstd_t"]
        mask = sequence_mask(outputs["mel_lengths"], z.shape[1])[..., None].to(z.dtype)
        denom = torch.clamp(global_count(mask.sum() * z.shape[-1]), min=1.0)
        nll = torch.sum((0.5 * torch.exp(-2 * logstd_t) * (z - mu_t) ** 2 + logstd_t) * mask)
        mle = (nll - logdet.sum()) / denom + 0.5 * math.log(2 * math.pi)
        durations = outputs["durations"]
        tok_mask = sequence_mask(targets.transcription_lengths, durations.shape[1]).to(z.dtype)
        d_err = (outputs["log_dur_pred"] - torch.log1p(durations)) ** 2 * tok_mask
        dur = d_err.sum() / torch.clamp(global_count(tok_mask.sum()), min=1.0)
        return {"mle": mle, "duration": self.duration_scale * dur}
