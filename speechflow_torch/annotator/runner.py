"""The annotator's 5-step runner (counterpart of ``speechflow_tpu/annotator/runner.py``):
a corpus of audio files with their text into aligned ``.TextGridStage3`` utterances.

0. transcripts: the ``.whisper`` files beside the audio are counted (``--asr file``,
   the default), or written by a recognizer (``--asr ctc:<checkpoint>``; ``whisper``
   needs ``transformers`` and raises);
1. ``SegGenerator.run``: ``<output_root>/SEGS/.../<N>.TextGrid`` + ``<N>.wav``;
2. the forced aligner's two stages: ``train_aligner`` on the data config of stage 1
   (``aligner_data_stage1.yml``: raw ``.TextGrid``, pauses from the text), the
   ``Aligner`` writes ``.TextGridStage1``; stage 2 (``aligner_data_stage2.yml``:
   pauses from stage 1's timestamps) trains warm-started (``-w``) from stage 1's
   last checkpoint and writes ``.TextGridStage2``;
3. the stage-2 aligner writes ``.TextGridStage3`` (speech bounds, the last token to
   the end of the audio);
4. ``speaker_stats.json``: utterances and seconds a speaker over the stage-3 grids.

``main`` writes ``annotation_report.json`` and returns it. A stage's data config is
``--data_config``, else the file beside ``--aligner_config``, in ``./configs`` or in
this checkout's ``configs``; the stages' experiments go to the aligner config's
``experiment.base_dir``. Without step 1 and without a ``SEGS`` directory in the output,
the grids under ``--data_root`` are aligned in place. Training and alignment run on the
GPU unless ``--device cpu``.

    python -m speechflow_torch.annotator.runner -d <corpus> -o <out> -vs default
    python -m speechflow_torch.annotator.runner -d <corpus> -o <out> --device cpu --max_steps 2
"""

from __future__ import annotations

import argparse
import json
import logging
import typing as tp
from pathlib import Path

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["main", "cli"]

REPO = Path(__file__).resolve().parents[2]


def _arguments() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="annotate a corpus: ASR, segs, the aligner's "
                                            "stages, correction, statistics")
    p.add_argument("-d", "--data_root", required=True)
    p.add_argument("-o", "--output_root", required=True)
    p.add_argument("--steps", nargs="*", type=int, default=[0, 1, 2, 3, 4])
    p.add_argument("--aligner_config", default="configs/aligner_model.yml")
    p.add_argument("--data_config", default=None,
                   help="one data config for both stages (default: "
                        "aligner_data_stage{1,2}.yml)")
    p.add_argument("--max_steps", type=int, default=None,
                   help="trainer.max_steps of both stages")
    p.add_argument("-vs", "--value_select", nargs="*", default=["debug"])
    p.add_argument("--lang", default="EN")
    p.add_argument("--use_whisper", action="store_true", help="the same as --asr whisper")
    p.add_argument("--asr", default=None,
                   help="file (the .whisper files beside the audio; default), whisper, "
                        "or ctc:<checkpoint.pkl>")
    p.add_argument("--device", default=None, help="cpu to run on the CPU")
    return p


def _stage_data_config(aligner_config: str, stage: int) -> str:
    name = f"aligner_data_stage{stage}.yml"
    for cand in (Path(aligner_config).parent / name, Path("configs") / name,
                 REPO / "configs" / name):
        if cand.exists():
            return str(cand)
    raise FileNotFoundError(name)


def _speaker_stats(segs_root: Path) -> tp.Dict[str, dict]:
    from speechflow_torch.io.flist import construct_file_list
    from speechflow_torch.io.seg import AudioSeg

    stats: tp.Dict[str, dict] = {}
    for f in construct_file_list(segs_root, ext=".TextGridStage3"):
        seg = AudioSeg.load(f)
        s = stats.setdefault(seg.speaker_name or "unknown", {"n": 0, "duration": 0.0})
        s["n"] += 1
        s["duration"] += seg.duration
    return stats


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> dict:
    from speechflow_torch.annotator.align import Aligner, AlignStage
    from speechflow_torch.annotator.asr import (
        CTCPhonemeASR,
        FileASR,
        WhisperASR,
        run_audio_transcription,
    )
    from speechflow_torch.annotator.seg_generator import SegGenerator

    args = _arguments().parse_args(argv)
    data_root, out_root = Path(args.data_root), Path(args.output_root)
    out_root.mkdir(parents=True, exist_ok=True)
    report: dict = {}

    asr_spec = args.asr or ("whisper" if args.use_whisper else "file")
    if asr_spec.startswith("ctc:"):
        asr = CTCPhonemeASR(asr_spec.split(":", 1)[1], device=args.device)
    elif asr_spec == "whisper":
        asr = WhisperASR()
    else:
        asr = FileASR()

    if 0 in args.steps:
        n = (len(list(data_root.rglob("*.whisper"))) if isinstance(asr, FileASR)
             else run_audio_transcription(data_root, asr=asr))
        report["transcribed"] = n
        LOGGER.info("step 0: %d transcripts", n)

    segs_root = out_root / "SEGS"
    if 1 in args.steps:
        paths = SegGenerator(asr=asr, lang=args.lang).run(data_root, segs_root)
        report["segs"] = len(paths)
        LOGGER.info("step 1: %d segs", len(paths))
    elif not segs_root.is_dir() and any(data_root.rglob("*.TextGrid")):
        segs_root = data_root  # grids made before: align them in place

    ckpts: tp.Dict[int, Path] = {}
    if 2 in args.steps:
        from speechflow_torch.scripts import train_aligner
        from speechflow_torch.training.saver import ExperimentSaver

        for stage in (1, 2):
            train_args = ["-c", args.aligner_config,
                          "-cd", args.data_config or _stage_data_config(args.aligner_config,
                                                                         stage),
                          "-vs", *args.value_select, "--data_root", str(segs_root)]
            if args.max_steps:
                train_args += ["--max_steps", str(args.max_steps)]
            if args.device:
                train_args += ["--device", args.device]
            if stage == 2 and ckpts.get(1):
                # stage 2 starts from stage 1's weights on stage 1's output
                train_args += ["-w", str(ckpts[1])]
            ckpts[stage] = ExperimentSaver.get_last_checkpoint(train_aligner.main(train_args))
            emitted = Aligner(ckpts[stage], device=args.device).run(segs_root, AlignStage(stage))
            report[f"stage{stage}_aligned"] = len(emitted)
            LOGGER.info("step 2 stage %d: %d aligned", stage, len(emitted))

    if 3 in args.steps and ckpts.get(2):
        emitted = Aligner(ckpts[2], device=args.device).run(segs_root, AlignStage.stage3)
        report["stage3"] = len(emitted)
        LOGGER.info("step 3: %d corrected", len(emitted))

    if 4 in args.steps:
        stats = _speaker_stats(segs_root)
        (out_root / "speaker_stats.json").write_text(json.dumps(stats, indent=2))
        report["speakers"] = stats
        LOGGER.info("step 4: stats for %d speakers", len(stats))

    (out_root / "annotation_report.json").write_text(json.dumps(report, indent=2, default=str))
    return report


def cli() -> None:
    """The console script: ``main`` with the exit status of a normal return."""
    main()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
