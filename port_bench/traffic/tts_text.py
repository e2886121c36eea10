"""Text-to-speech traffic: rows of tokens, speakers and linguistic features as
the flagship bench draws them (a frozen copy of ``serving.bench_inputs``'s
draws), in a closed loop of back-to-back calls of ``batch`` rows each.

Tokens per row are ``{"fixed": n}`` or ``{"lognormal": {median, sigma, min,
max}}``. So that every seed does the same work, the row lengths are one fixed
multiset (the distribution's quantiles) that the seed only shuffles, and rows
of varying length are dealt into batches of near-equal token totals; the seed
draws the tokens, speakers and features. A call's rows are padded to its
longest row, rounded up to ``pad_multiple`` (``TTSCollate``'s
``token_multiple``). ``pool`` distinct calls are made and the loop cycles
through them.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import typing as tp

import numpy as np
import torch


@dataclasses.dataclass
class Call:
    """One call of the program: host tensors as a client sends them."""
    inputs: tp.Dict[str, torch.Tensor]
    lengths: tp.List[int]          # valid tokens a row
    rows: int
    tokens: int                    # padded width


def bench_rows(rng: np.random.Generator, batch: int, n_tokens: int, t_frames: int,
               n_symbols: int, n_speakers: int) -> tp.Dict[str, torch.Tensor]:
    """A frozen copy of ``serving.bench_inputs``'s draws, in its order, as a dict:
    lognormal teacher durations filling ``t_frames`` (read only when teacher-forced),
    ling/LM/XPBERT features, tokens, speakers, language 0."""
    raw = rng.lognormal(mean=1.8, sigma=0.5, size=(batch, n_tokens))
    durs = np.maximum(np.round(raw / raw.sum(-1, keepdims=True) * t_frames), 1.0)
    durs[:, -1] = np.maximum(durs[:, -1] + (t_frames - durs.sum(-1)), 1.0)
    feats = dict(
        ling_feat=torch.from_numpy(rng.uniform(0, 1, (batch, n_tokens, 56))).float(),
        lm_feat=torch.from_numpy(rng.normal(size=(batch, n_tokens, 32))).float(),
        xpbert_feat=torch.from_numpy(rng.normal(size=(batch, n_tokens, 32))).float(),
    )
    return dict(
        transcription=torch.from_numpy(rng.integers(1, n_symbols, (batch, n_tokens))),
        transcription_lengths=torch.full((batch,), n_tokens, dtype=torch.int32),
        speaker_id=torch.from_numpy(rng.integers(0, n_speakers, (batch,))),
        lang_id=torch.zeros((batch,), dtype=torch.int64),
        durations=torch.from_numpy(durs.astype(np.float32)),
        **feats,
    )


def quantile_lengths(spec: dict, n: int) -> tp.List[int]:
    """n row lengths: the fixed value, or the lognormal's quantiles at (i + 0.5) / n."""
    if "fixed" in spec:
        return [int(spec["fixed"])] * n
    ln = spec["lognormal"]
    dist = statistics.NormalDist(math.log(ln["median"]), ln["sigma"])
    return [int(min(max(round(math.exp(dist.inv_cdf((i + 0.5) / n))), ln["min"]), ln["max"]))
            for i in range(n)]


def _pad(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _call(rng: np.random.Generator, lengths: tp.Sequence[int], params: dict,
          model: dict) -> Call:
    width = _pad(max(lengths), params.get("pad_multiple", 1))
    rows = bench_rows(rng, len(lengths), width, params["t_out"], model["n_symbols"],
                      model["n_speakers"])
    lens = torch.tensor(lengths, dtype=torch.int32)
    valid = torch.arange(width)[None, :] < lens[:, None]
    rows["transcription"] = rows["transcription"] * valid
    for name in ("ling_feat", "lm_feat", "xpbert_feat"):
        rows[name] = rows[name] * valid[..., None]
    rows["durations"] = rows["durations"] * valid
    rows["transcription_lengths"] = lens
    return Call(rows, list(lengths), len(lengths), width)


def make_calls(params: dict, seed: int, model: dict) -> tp.List[Call]:
    """The workload's ``pool`` calls for ``seed``."""
    rng = np.random.default_rng(seed)
    pool, batch = params["pool"], params["batch"]
    lengths = [int(n) for n in rng.permutation(quantile_lengths(params["tokens"], pool * batch))]
    if "fixed" not in params["tokens"]:
        lengths = _balanced(lengths, pool, batch, rng)
    return [_call(rng, lengths[i * batch:(i + 1) * batch], params, model) for i in range(pool)]


def _balanced(lengths: tp.Sequence[int], n: int, batch: int, rng) -> tp.List[int]:
    """The rows dealt into ``n`` batches of ``batch`` whose token totals are as near
    equal as a greedy deal of the longest first makes them: the same batches for
    every seed, in an order and with rows in orders the seed shuffles. A window
    that ends inside a pass over the pool then does the same work whichever
    batches it ends on."""
    groups: tp.List[tp.List[int]] = [[] for _ in range(n)]
    for length in sorted(lengths, reverse=True):
        g = min((g for g in groups if len(g) < batch), key=sum)
        g.append(length)
    return [int(x) for i in rng.permutation(n) for x in rng.permutation(groups[i])]
