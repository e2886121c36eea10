"""Vocoder feature extractors (counterpart of
``speechflow_tpu/models/vocoder/feature_extractors.py``; the slice needs
``AudioFeatures``, the pass-through of precomputed features)."""

from __future__ import annotations

import torch
import torch.nn as nn

__all__ = ["AudioFeatures"]


class AudioFeatures(nn.Module):
    """Pass through a precomputed feature stream (e.g. ``mel``)."""

    def __init__(self, feature: str = "mel", dim_in: int = 100):
        super().__init__()
        self.feature = feature
        self.dim = dim_in

    def forward(self, inputs) -> torch.Tensor:
        return inputs[self.feature] if isinstance(inputs, dict) \
            else getattr(inputs, self.feature)
