"""A trained aligner over annotated utterances: MAS durations -> phoneme
timestamps -> ``.TextGridStage{N}`` files (counterpart of
``speechflow_tpu/annotator/align.py``).

- stage 1 reads the seg generator's ``.TextGrid`` files, stage N >= 2 the
  ``.TextGridStage{N-1}`` ones (``AlignStage.input_ext``);
- each file goes through the checkpoint's own data pipeline: its parser
  (filters, audio strip and its pad) and its handlers, so each stage's pause
  rules travel with the model;
- files are sorted by size (a duration proxy) and aligned ``batch_size`` at a
  time through the model's deterministic ``align`` (the encoder's attention
  through the fused kernel on the GPU);
- timestamps are mapped back through the parser's audio strip;
- from stage 2 on, pauses shorter than ``min_pause_len`` are merged into their
  neighbours (``_remove_small_pauses``); stage 3 marks the speech bounds in the
  meta and extends the last token to the end of the audio.

The output is written beside its input. A checkpoint of the port's trainer or
of the JAX package's (orbax) loads alike.
"""

from __future__ import annotations

import enum
import logging
import typing as tp
from pathlib import Path

import numpy as np
import torch

from speechflow_torch.convert import load_nnx_state
from speechflow_torch.data.core.components import DataPipeline, _known_kwargs
from speechflow_torch.data.parsers import PARSERS
from speechflow_torch.io.flist import construct_file_list
from speechflow_torch.io.seg import AudioSeg, Tier
from speechflow_torch.io.timestamps import Timestamps
from speechflow_torch.models.aligner import AlignerBatchProcessor, GlowTTSAligner, GlowTTSParams
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.utils.device import resolve_device

__all__ = ["Aligner", "AlignStage"]

LOGGER = logging.getLogger("speechflow_torch")

Interval = tp.Tuple[float, float, str]
SERVICE = ("<BOS>", "<EOS>", "<PAD>", "<SIL>")


class AlignStage(enum.Enum):
    stage1 = 1
    stage2 = 2
    stage3 = 3

    @property
    def input_ext(self) -> str:
        """The grids this stage aligns."""
        return ".TextGrid" if self is AlignStage.stage1 else f".TextGridStage{self.value - 1}"


class Aligner:
    def __init__(self, ckpt_path: tp.Union[str, Path], batch_size: int = 16,
                 min_pause_len: float = 0.08,
                 device: tp.Union[str, torch.device, None] = None):
        """The aligner of checkpoint ``ckpt_path`` on ``device`` (the GPU unless
        ``device="cpu"``), in float32."""
        dev = resolve_device(device)
        tree, payload = ExperimentSaver.load_checkpoint(ckpt_path)
        self.payload = payload
        info = payload["pipeline_info"]
        self.pipeline = DataPipeline.from_info(info)
        params = GlowTTSParams.create(payload["model_params"])
        model_tree = ExperimentSaver.remap_legacy_keys(tree["model"])
        self.model = load_nnx_state(GlowTTSAligner(params), model_tree).to(dev).eval()
        self.device = dev
        self.batch_processor = AlignerBatchProcessor()
        self.batch_size = batch_size
        self.min_pause_len = min_pause_len
        cfg = info["config"]
        pipe_cfg = (cfg.get("preproc") or {}).get("pipe_cfg") or {}
        self.hop = int((pipe_cfg.get("magnitude") or {}).get("hop_len", 256))
        self.sr = int((pipe_cfg.get("load_audio") or {}).get("sample_rate", 24000))
        parser_cfg = dict(cfg.get("parser") or {})
        ptype = parser_cfg.pop("type", "TTSDSParser")
        self.parser = PARSERS[ptype](**_known_kwargs(PARSERS[ptype], parser_cfg, ptype))

    def _to_datasample(self, seg_path: Path):
        """The pipeline parser's sample of one file (None when its filters drop it)."""
        md = self.parser.run_preprocessing(self.parser.reader(seg_path)[0])
        return None if md is None else self.parser.to_datasample(md)

    def align_seg(self, seg_path: tp.Union[str, Path],
                  stage: AlignStage = AlignStage.stage1) -> Path:
        out = self._align_batch([Path(seg_path)], stage)
        if not out:
            raise RuntimeError(f"alignment failed for {seg_path}")
        return out[0]

    def batch_inputs(self, seg_paths: tp.Sequence[Path]):
        """(the processed samples, the model's inputs on the CPU) of the files that
        parse and pass the parser's filters, in order; None when none does."""
        samples = []
        for p in seg_paths:
            try:
                ds = self._to_datasample(p)
            except Exception as e:  # a broken file is skipped, as the JAX aligner does
                LOGGER.warning("parse failed on %s: %r", p, e)
                continue
            if ds is None:
                LOGGER.info("seg filtered out by parser: %s", p)
                continue
            samples.append(ds)
        if not samples:
            return None
        processed = []
        for ds in samples:
            for fn in self.pipeline.preproc_fns:
                ds = fn(ds)
            processed.append(ds)
        inputs, _ = self.batch_processor(self.pipeline.collate_fn(processed))
        return processed, inputs

    def _align_batch(self, seg_paths: tp.Sequence[Path], stage: AlignStage) -> tp.List[Path]:
        batch = self.batch_inputs(seg_paths)
        if batch is None:
            return []
        processed, inputs = batch
        durations, _ = self.model.align(inputs.to(self.device, torch.float32))
        durs = durations.cpu().numpy()
        tok_lens = inputs.transcription_lengths.numpy()
        trans = inputs.transcription.numpy()
        out: tp.List[Path] = []
        spf = self.hop / self.sr
        for i, ds in enumerate(processed):
            p = Path(ds.sega_path or ds.file_path)
            try:
                n_tok = int(tok_lens[i])
                symbols = self.pipeline.alphabet.decode(trans[i][:n_tok])
                token_ts = Timestamps.from_durations(durs[i][:n_tok] * spf)
                seg = AudioSeg.load(p)
                # the pipeline's coordinates (after the audio strip) -> the grid's
                offset = 0.0
                if ds.audio_chunk is not None and seg.audio_chunk is not None:
                    offset = float((ds.audio_chunk.begin or 0.0)
                                   - (seg.audio_chunk.begin or 0.0))
                out.append(self._emit(seg, p, symbols, token_ts, stage, offset))
            except Exception as e:  # one bad file does not stop the batch
                LOGGER.warning("emission failed on %s: %r", p, e)
        return out

    def _emit(self, seg: AudioSeg, seg_path: Path, symbols: tp.Sequence[str],
              token_ts: Timestamps, stage: AlignStage, offset: float = 0.0) -> Path:
        dur_total = seg.duration
        intervals: tp.List[Interval] = []
        for lab, (b, e) in zip(symbols, token_ts):
            lab = "" if lab in SERVICE else lab
            b, e = b + offset, e + offset
            intervals.append((max(min(b, dur_total), 0.0), max(min(e, dur_total), 0.0), lab))
        if intervals and intervals[0][0] > 1e-6:  # the strip's leading gap is a pause
            intervals.insert(0, (0.0, intervals[0][0], ""))
        if intervals and intervals[-1][1] < dur_total:
            b, e, lab = intervals[-1]
            if stage is AlignStage.stage3 and lab:
                intervals[-1] = (b, dur_total, lab)  # the last token to the end
            else:
                intervals.append((intervals[-1][1], dur_total, ""))
        if stage is not AlignStage.stage1:
            intervals = self._remove_small_pauses(intervals, self.min_pause_len)

        seg.grid.add(Tier("phonemes", intervals))
        if stage is AlignStage.stage3:
            non_empty = [iv for iv in intervals if iv[2]]
            if non_empty:
                seg.meta.update(bos_label="", eos_label="", speech_begin=non_empty[0][0],
                                speech_end=non_empty[-1][1])
        seg.meta["aligner_model"] = str(self.payload.get("git_commit", "speechflow_torch"))
        out = Path(str(seg_path).split(".TextGrid")[0] + f".TextGridStage{stage.value}")
        seg.save(out)
        return out

    @staticmethod
    def _remove_small_pauses(intervals: tp.List[Interval], min_len: float) -> tp.List[Interval]:
        """Pauses shorter than ``min_len`` merged into their neighbours, the gap
        split at its midpoint; the first and last intervals always stay."""
        out: tp.List[list] = []
        n = len(intervals)
        for idx, (b, e, lab) in enumerate(intervals):
            is_edge = idx == 0 or idx == n - 1
            if not lab and not is_edge and (e - b) < min_len and out:
                mid = 0.5 * (b + e)
                out[-1][1] = mid
                out.append([mid, mid, None])  # the next token starts at the midpoint
                continue
            out.append([b, e, lab])
        merged: tp.List[Interval] = []
        pending: tp.Optional[float] = None
        for b, e, lab in out:
            if lab is None:
                pending = b
                continue
            if pending is not None:
                b, pending = pending, None
            merged.append((b, e, lab))
        return merged

    def run(self, segs_root: tp.Union[str, Path], stage: AlignStage = AlignStage.stage1,
            ext: tp.Optional[str] = None) -> tp.List[Path]:
        """Align every file of ``stage``'s input extension (or ``ext``) under
        ``segs_root``, smallest first, ``batch_size`` at a time."""
        ext = ext or stage.input_ext
        files = [Path(f) for f in construct_file_list(segs_root, ext=ext)]
        if ext == ".TextGrid":
            files = [f for f in files if ".TextGridStage" not in f.name]
        files.sort(key=lambda f: f.stat().st_size if f.exists() else 0)
        out: tp.List[Path] = []
        for i in range(0, len(files), self.batch_size):
            out.extend(self._align_batch(files[i:i + self.batch_size], stage))
        return out
