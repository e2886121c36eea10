"""The traffic generators repeat by seed and differ across seeds, every seed
draws the same sizes, and the sentences' lengths are those of the corpus the
workload names."""

import math
import statistics

import debug_cells  # noqa: F401  (puts the checkout on sys.path)
import torch

from port_bench import core
from port_bench.traffic import audio_chunks, tts_text

BIG_SEED = 2 ** 31 + 11


def _text(name, seed):
    wl = core.load_json(core.HERE / "workloads" / f"{name}.json")["traffic"]
    cfg = core.load_json(core.HERE / "configs" / "cfm-dit-bigvgan.json")["acoustic_model"]
    return tts_text.make_calls(wl, seed, cfg)


def _same(a, b):
    return all(torch.equal(x.inputs[k], y.inputs[k]) for x, y in zip(a, b) for k in x.inputs)


def test_text_traffic_repeats_by_seed_and_differs_across_seeds():
    for name in ("cfm-bigvgan.b32-long", "cfm-bigvgan.b32-sentences"):
        a, b, c = _text(name, BIG_SEED), _text(name, BIG_SEED), _text(name, 7)
        assert _same(a, b)
        assert not _same(a, c)
        # the same multiset of sizes for every seed, in another order
        assert sorted(n for x in a for n in x.lengths) == sorted(n for x in c for n in x.lengths)
        assert sorted(x.rows for x in a) == sorted(x.rows for x in c)


def test_text_traffic_shapes():
    calls = _text("cfm-bigvgan.b32-sentences", 3)
    assert [x.rows for x in calls] == [32] * 4
    for x in calls:
        assert x.tokens == max(x.lengths)
        lens = x.inputs["transcription_lengths"]
        assert (x.inputs["transcription"][torch.arange(x.tokens)[None] >= lens[:, None]] == 0).all()
    lengths = [n for x in calls for n in x.lengths]
    assert min(lengths) >= 8 and max(lengths) <= 128
    assert 40 <= sorted(lengths)[len(lengths) // 2] <= 56  # median 48


def _segs_tokens():
    """Tokens of each SEGS utterance as TTSTextProcessor encodes its phonemes:
    the intervals of the TextGridStage3 ``phonemes`` tier (a pause is a SIL
    token), BOS and EOS."""
    counts = []
    for path in sorted((core.ROOT / "tests/data/SEGS").rglob("*.TextGridStage3")):
        lines = [x.strip() for x in path.read_text(encoding="utf-8").splitlines()]
        at = next(i for i in range(len(lines) - 1)
                  if lines[i] == '"IntervalTier"' and lines[i + 1] == '"phonemes"')
        counts.append(int(lines[at + 4]) + 2)
    return counts


def test_sentence_lengths_fit_the_corpus():
    counts = _segs_tokens()
    assert len(counts) == 50
    logs = [math.log(n) for n in counts]
    ln = core.load_json(core.HERE / "workloads" / "cfm-bigvgan.b32-sentences.json")[
        "traffic"]["tokens"]["lognormal"]
    assert abs(math.exp(statistics.mean(logs)) / ln["median"] - 1) < 0.02
    assert abs(statistics.stdev(logs) - ln["sigma"]) < 0.01
    assert ln["min"] <= min(counts) and max(counts) <= ln["max"]


def test_audio_chunks_repeat_by_seed_and_differ_across_seeds():
    wl = core.load_json(core.HERE / "workloads" / "bigvgan-gan.b32-1s.json")["traffic"]
    cfg = core.load_json(core.HERE / "configs" / "bigvgan-gan-train.json")
    params = dict(wl, batch=4, micro_batches=3, **cfg["data"])
    a, b, c = (audio_chunks.Chunks(params, s, "cpu", core.ROOT) for s in (BIG_SEED, BIG_SEED, 5))
    assert torch.equal(a.plan, b.plan) and not torch.equal(a.plan, c.plan)
    x = a.batch_at(1)
    assert x.shape == (4, 24064) and float(x[:, 24000:].abs().max()) == 0.0
    assert 0.0 < float(x.abs().max()) <= 0.95 + 1e-6
    assert torch.equal(x, b.batch_at(1))
