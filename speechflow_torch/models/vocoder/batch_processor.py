"""Vocoder batch processor (counterpart of
``speechflow_tpu/models/vocoder/batch_processor.py``): a collated audio batch
-> (inputs, targets) dicts of tensors on ``device``; the waveform is both the
generator's input (the mel is computed on the device) and its target."""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

__all__ = ["VocoderBatchProcessor"]


class VocoderBatchProcessor:
    def __init__(self, use_mel: bool = False,
                 device: tp.Union[str, torch.device] = "cpu"):
        self.use_mel = use_mel
        self.device = torch.device(device)

    def _tensor(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.require(x, requirements=("C", "W")))  # a loader's views are read-only
        return t.to(self.device, non_blocking=True)

    def __call__(self, batch) -> tp.Tuple[dict, dict]:
        c = getattr(batch, "collated_samples", batch)
        get = (lambda k: c.get(k)) if isinstance(c, dict) else (lambda k: getattr(c, k, None))
        wav = self._tensor(get("waveform"))
        inputs: tp.Dict[str, torch.Tensor] = {"waveform": wav}
        if self.use_mel and get("mel") is not None:
            inputs["mel"] = self._tensor(get("mel"))
        for key in ("pitch", "speaker_emb"):
            if get(key) is not None:
                inputs[key] = self._tensor(get(key))
        return inputs, {"waveform": wav}
