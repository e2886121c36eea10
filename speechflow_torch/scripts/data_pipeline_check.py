"""Pipeline check (counterpart of ``speechflow_tpu/scripts/data_pipeline_check.py``):
build the pipeline of a data config, check each subset's handler IO contracts
(``PipeRegistry.check`` from the parser's fields), draw ``--n_batches``
batches of ``--batch_size`` from its sampler and print, for each, its size and
every array field of the collated batch with its shape, dtype and range: the
JAX script's report, line for line. ``--profile`` adds each handler's host ms
a sample over those batches.

    python -m speechflow_torch.scripts.data_pipeline_check -cd configs/tts_data_24khz.yml \\
        [-vs debug] [--data_root ...] [--profile]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
import typing as tp

import numpy as np

from speechflow_torch.data.core.components import DataPipeline
from speechflow_torch.data.core.registry import PipeRegistry
from speechflow_torch.io.config import Config

__all__ = ["INITIAL_FIELDS", "main"]

#: the fields a parsed sample has before any handler
INITIAL_FIELDS = {"audio_chunk", "phonemes", "phoneme_timestamps", "text"}
#: the collated fields in the order the JAX report lists them
REPORT_ORDER = ("waveform", "waveform_lengths", "speaker_id", "lang_id", "speaker_emb",
                "additional", "mel", "mel_lengths", "magnitude", "energy", "pitch", "averages",
                "transcription", "transcription_lengths", "durations", "gate",
                "aggregate_pitch", "aggregate_energy", "ling_feat", "lm_feat", "xpbert_feat",
                "prosody")


class _Timed:
    """A handler that adds its wall time to ``sink[name]``; ``func`` keeps its
    contract visible to ``PipeRegistry.meta``."""

    def __init__(self, fn: tp.Callable, name: str, sink: tp.Dict[str, tp.List[float]]):
        self.func, self.name, self.sink = fn, name, sink

    def __call__(self, ds):
        t0 = time.perf_counter()
        out = self.func(ds)
        self.sink.setdefault(self.name, []).append(1e3 * (time.perf_counter() - t0))
        return out


def _field_lines(c) -> tp.List[str]:
    names = [f.name for f in dataclasses.fields(c)]
    order = [n for n in REPORT_ORDER if n in names] + [n for n in names if n not in REPORT_ORDER]
    lines = []
    for name in order:
        v = getattr(c, name)
        if isinstance(v, np.ndarray):
            lines.append(f"    {name:24s} {str(v.shape):18s} {str(v.dtype):8s} "
                         f"[{np.nanmin(v):+.3g}, {np.nanmax(v):+.3g}]")
    return lines


def main(argv=None) -> tp.List[str]:
    p = argparse.ArgumentParser(description="handler contracts and batches of a data config")
    p.add_argument("-cd", "--data_config", required=True)
    p.add_argument("-vs", "--value_select", nargs="*", default=None)
    p.add_argument("--data_root", default=None)
    p.add_argument("--n_batches", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--profile", action="store_true", help="print each handler's host ms")
    args = p.parse_args(argv)

    cfg = Config.create_from_file(args.data_config, value_select=args.value_select).to_dict()
    if args.data_root:
        cfg.setdefault("dirs", {})["data_root"] = str(args.data_root)
    dp = DataPipeline.from_config(cfg)
    handler_ms: tp.Dict[str, tp.List[float]] = {}
    if args.profile:
        dp.preproc_fns = [_Timed(fn, name, handler_ms)
                          for fn, name in zip(dp.preproc_fns, dp.handler_names)]
    process = dp.process

    lines = []
    for subset in dp.info["subsets"]:
        lines.append(f"[{subset}] dataset: {len(dp.datasets[subset])} samples")
        try:
            PipeRegistry.check(dp.preproc_fns, initial_fields=INITIAL_FIELDS)
            lines.append(f"[{subset}] handler IO contracts: OK")
        except ValueError as e:
            lines.append(f"[{subset}] handler IO contracts: {e}")
        for b in range(args.n_batches):
            samples, is_last = dp.samplers[subset].sampling(args.batch_size)
            kept = [d for d in (process.sample(s) for s in samples) if d is not None]
            lines.append(f"[{subset}] batch {b}: size={len(kept)} is_last={is_last}")
            if kept:
                lines.extend(_field_lines(dp.collate_fn(kept)))
    if args.profile:
        lines.append("handler host ms a sample (mean over the batches' samples):")
        lines.extend(f"    {name:28s} {np.mean(ms):10.3f}" for name, ms in handler_ms.items())
    print("\n".join(lines))
    return lines


def cli() -> None:
    main()


if __name__ == "__main__":
    main()
