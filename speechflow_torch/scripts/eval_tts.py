"""Synthesis from the command line (counterpart of
``speechflow_tpu/scripts/eval_tts.py``): texts through an acoustic-model
checkpoint and, with ``--vocoder_ckpt``, a vocoder checkpoint; for text ``i``
it writes ``{i}.mel.npy`` (the postnet mel of every sentence, its valid frames
concatenated) and ``{i}.wav``. A checkpoint is a ``step_*`` directory of either
package (the port's ``model.npz`` or a JAX orbax checkpoint), or an experiment
directory, whose last checkpoint is taken. Runs on the GPU unless
``--device cpu``.

    python -m speechflow_torch.scripts.eval_tts --tts_ckpt <dir> \\
        [--vocoder_ckpt <dir>] [--text "..." ...] [--out eval_out] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import typing as tp
from pathlib import Path

import numpy as np
import torch

from speechflow_torch.training.saver import ExperimentSaver, is_checkpoint

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["DEFAULT_TEXTS", "checkpoint_of", "main"]

DEFAULT_TEXTS = [
    "Printing, in the only sense with which we are at present concerned.",
    "The quick brown fox jumps over the lazy dog!",
]


def checkpoint_of(path: tp.Union[str, Path]) -> Path:
    """``path`` if it is a checkpoint, else the last checkpoint under it."""
    if is_checkpoint(path):
        return Path(path)
    ckpt = ExperimentSaver.get_last_checkpoint(path)
    if ckpt is None:
        raise FileNotFoundError(f"{path}: neither a checkpoint nor an experiment with one")
    return ckpt


def main(argv=None) -> tp.List[str]:
    p = argparse.ArgumentParser(description="text -> mel (and waveform) from checkpoints")
    p.add_argument("--tts_ckpt", required=True)
    p.add_argument("--vocoder_ckpt", default=None)
    p.add_argument("--text", nargs="*", default=None)
    p.add_argument("--lang", default=None)
    p.add_argument("--speaker", default=None)
    p.add_argument("--out", default="eval_out")
    p.add_argument("--t_out", type=int, default=512)
    p.add_argument("--device", default=None, help="cpu, else the GPU")
    args = p.parse_args(argv)

    from speechflow_torch.interface.tts_interface import TTSEvaluationInterface, TTSOptions
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface

    ckpt = checkpoint_of(args.tts_ckpt)
    iface = TTSEvaluationInterface.from_checkpoint(*ExperimentSaver.load_checkpoint(ckpt),
                                                   ckpt_path=ckpt, device=args.device)
    lang = args.lang or (iface.get_languages() or ["EN"])[0]
    speaker = args.speaker or (iface.get_speakers() or [None])[0]
    voc = None
    if args.vocoder_ckpt:
        voc = VocoderEvaluationInterface.from_checkpoint(
            *ExperimentSaver.load_checkpoint(checkpoint_of(args.vocoder_ckpt)),
            device=args.device)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for i, text in enumerate(args.text or DEFAULT_TEXTS):
        with torch.inference_mode():
            out = iface.synthesize(text, lang=lang, speaker=speaker,
                                   opts=TTSOptions(t_out=args.t_out))
            mels = out.after_postnet_spectrogram.float().cpu().numpy()
            lens = out.spectrogram_lengths.cpu().numpy()
        mel = np.concatenate([mels[j][:int(lens[j])] for j in range(mels.shape[0])])
        np.save(out_dir / f"{i}.mel.npy", mel)
        written.append(str(out_dir / f"{i}.mel.npy"))
        if voc is not None:
            voc.synthesize(mel).save(out_dir / f"{i}.wav", overwrite=True)
            written.append(str(out_dir / f"{i}.wav"))
        LOGGER.info("synthesized %r -> %d frames", text[:40], len(mel))
    print("\n".join(written))
    return written


def cli() -> None:
    main()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
