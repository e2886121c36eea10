"""SSML prosody modifiers (counterpart of
``speechflow_tpu/data/processors/ssml.py``): ``<prosody pitch/rate/volume>``
spans of the input text become per-token factors that the variance adaptor
multiplies onto its predictions (pitch, energy) or divides the durations by
(rate)."""

from __future__ import annotations

import re
import typing as tp

import numpy as np

from speechflow_torch.data.core.datasample import TTSDataSample
from speechflow_torch.data.processors import handler

__all__ = ["parse_ssml", "apply_ssml_modifiers"]

_TAG = re.compile(r"<prosody([^>]*)>(.*?)</prosody>", re.DOTALL)
_ATTR = re.compile(r"(pitch|rate|volume)\s*=\s*\"([^\"]+)\"")
_NAMED = {"x-low": 0.7, "low": 0.85, "medium": 1.0, "default": 1.0,
          "high": 1.15, "x-high": 1.3, "x-slow": 0.6, "slow": 0.8,
          "fast": 1.25, "x-fast": 1.5, "x-soft": 0.5, "soft": 0.75,
          "loud": 1.35, "x-loud": 1.7}
MODIFIERS = (("pitch", "pitch_modifier"), ("volume", "volume_modifier"),
             ("rate", "rate_modifier"))


def _to_factor(value: str) -> float:
    value = value.strip()
    if value.endswith("%"):
        return 1.0 + float(value[:-1]) / 100.0
    if value in _NAMED:
        return _NAMED[value]
    try:
        return float(value)
    except ValueError:
        return 1.0


def parse_ssml(text: str) -> tp.Tuple[str, tp.List[tp.Tuple[str, dict]]]:
    """SSML-ish text -> (plain words joined, [(word, modifiers), ...])."""
    out: tp.List[tp.Tuple[str, dict]] = []
    pos = 0
    for m in _TAG.finditer(text):
        out += [(w, {}) for w in text[pos:m.start()].split()]
        mods = {k: _to_factor(v) for k, v in _ATTR.findall(m.group(1))}
        out += [(w, dict(mods)) for w in m.group(2).split()]
        pos = m.end()
    out += [(w, {}) for w in text[pos:].split()]
    return " ".join(w for w, _ in out), out


@handler(inputs={"transcription"},
         outputs={"pitch_modifier", "volume_modifier", "rate_modifier"})
def apply_ssml_modifiers(ds: TTSDataSample) -> TTSDataSample:
    """Word-level SSML modifiers to token level (uniform within a word; 1.0
    outside any span), into ``ds.additional``. Reads
    ``ds.additional['ssml']`` (the ``parse_ssml`` word list) and
    ``ds.word_lengths`` (tokens per word)."""
    n = ds.n_tokens
    mods = {mkey: np.ones(n, np.float32) for _, mkey in MODIFIERS}
    ssml = ds.additional.get("ssml")
    wl = ds.word_lengths
    if ssml is not None and wl is not None and len(ssml) == len(wl):
        pos = 0
        for (_, factors), count in zip(ssml, wl):
            for key, mkey in MODIFIERS:
                if key in factors:
                    mods[mkey][pos:pos + count] = factors[key]
            pos += count
    ds.additional.update(mods)
    return ds
