"""Writes ``tests/data/jax_checkpoints/``: checkpoints the JAX package's trainers
write, and the JAX package's output for one sentence, so that the port (which
reads them without JAX, orbax or tensorstore) can be held to them on the CPU
and on the GPU. Run it once, by hand, where JAX runs (it is not a test):

    JAX_PLATFORMS=cpu python tests/make_jax_checkpoints.py

It writes:

- ``tts/``: the last checkpoint (``step_000000002``) of
  ``speechflow_tpu/scripts/train_tts.py -c configs/tts_model.yml -vs debug``
  after 2 steps on ``tests/data/SEGS``, and its ``g2p.pkl`` (the configs' text
  is in each checkpoint's payload);
- ``vocoder/``: the last checkpoint of ``train_vocoder.py -c
  configs/vocoder_bigvgan.yml -vs debug`` after 2 steps (the BigVGAN head, whose
  activations run the anti-alias kernel);
- ``reference.npz``: for ``SENTENCE`` by the first speaker, with ``FRAMES``
  frames injected as each token's duration (the JAX duration predictor's
  output replaced, as the port replaces its own), the JAX interfaces' mel after
  the postnet (``mel``, the valid frames) and the vocoder's waveform of it
  (``wav``). The debug model's decoder is the wrapper, which draws no noise.

Three cuts keep the directory under 4 MB (the recipes' checkpoints are 23 MB
and 12 MB): the three variance predictors are 32 wide (the recipe's 256 are
8 MB of weights alone), the discriminators have 2 channels, not the debug
recipe's 8, and each checkpoint is saved again by the JAX ``ExperimentSaver``
without its optimizer state (Adam's two moments double a tree).
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import typing as tp
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "data" / "jax_checkpoints"
SEGS = REPO / "tests" / "data" / "SEGS"
SENTENCE = "Printing, in the only sense with which we are at present concerned."
STEPS = 2
FRAMES = 4  # frames a token, injected


def _fixture_configs(tmp: Path) -> tp.Tuple[Path, Path]:
    tts = (REPO / "configs" / "tts_model.yml").read_text()
    for name in ("aggregate_pitch", "aggregate_energy", "durations"):
        tts = tts.replace(f"- {{name: {name}}}", f"- {{name: {name}, dim: 32}}")
    voc = (REPO / "configs" / "vocoder_bigvgan.yml").read_text()
    voc = voc.replace("channels: {default: 32, debug: 8}", "channels: {default: 32, debug: 2}")
    assert tts.count("dim: 32}") == 3 and "debug: 2}\n" in voc
    (tmp / "tts_model.yml").write_text(tts)
    (tmp / "vocoder_bigvgan.yml").write_text(voc)
    return tmp / "tts_model.yml", tmp / "vocoder_bigvgan.yml"


def _train(script, model_yml: Path, data_yml: str, workdir: Path) -> Path:
    os.chdir(workdir)
    expr = script.main(["-c", str(model_yml), "-cd", str(REPO / "configs" / data_yml),
                        "-vs", "debug", "--max_steps", str(STEPS), "--data_root", str(SEGS),
                        "--platform", "cpu"])
    return Path(expr).resolve()


def _copy_run(expr: Path, dst: Path, tmp: Path, extra: tp.Sequence[str] = ()) -> Path:
    """The run's last checkpoint, saved again by the JAX saver without ``opt``."""
    from speechflow_tpu.training.saver import ExperimentSaver

    tree, payload = ExperimentSaver.load_checkpoint(expr / "checkpoints" / f"step_{STEPS:09d}")
    saver = ExperimentSaver(tmp / "resaved", expr_suffix=dst.name)
    ckpt = saver.save(int(tree["step"]), tree["model"], extra=payload)
    shutil.copytree(ckpt, dst / ckpt.name)
    for name in extra:
        shutil.copy(expr / name, dst / name)
    return dst / ckpt.name


def _reference(tts_ckpt: Path, voc_ckpt: Path) -> dict:
    from speechflow_tpu.interface.tts_interface import TTSEvaluationInterface, TTSOptions
    from speechflow_tpu.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_tpu.models.tts import predictors

    tts = TTSEvaluationInterface(tts_ckpt)
    speaker = tts.get_speakers()[0]
    opts = TTSOptions(t_out=512)
    inputs = tts.prepare_batch(tts.split_sentences(SENTENCE),
                               tts.create_context("EN", speaker), opts)
    n_tokens = int(np.asarray(inputs.transcription_lengths)[0])
    width = np.asarray(inputs.transcription).shape[1]
    durations = np.where(np.arange(width) < n_tokens, float(FRAMES), 0.0)[None]
    own = predictors.TokenLevelDP.to_durations
    predictors.TokenLevelDP.to_durations = staticmethod(
        lambda log_d, lengths: np.asarray(durations, np.float32))
    try:
        out = tts.synthesize(SENTENCE, lang="EN", speaker=speaker, opts=opts)
    finally:
        predictors.TokenLevelDP.to_durations = own
    n = int(np.asarray(out.spectrogram_lengths)[0])
    assert n == FRAMES * n_tokens and (np.asarray(out.attention).sum(1) == durations).all()
    mel = np.asarray(out.after_postnet_spectrogram)[0, :n]
    wav = VocoderEvaluationInterface(voc_ckpt).synthesize(mel).data
    return {"sentence": np.array(SENTENCE), "speaker": np.array(speaker),
            "t_out": np.array(opts.t_out), "durations": durations.astype(np.float32),
            "mel": mel.astype(np.float32), "wav": np.asarray(wav, np.float32)}


def main() -> None:
    from speechflow_tpu.scripts import train_tts, train_vocoder

    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    here = Path.cwd()
    with tempfile.TemporaryDirectory(prefix="jax_ckpt_") as td:
        tmp = Path(td)
        tts_yml, voc_yml = _fixture_configs(tmp)
        try:
            tts_expr = _train(train_tts, tts_yml, "tts_data_24khz.yml", tmp)
            voc_expr = _train(train_vocoder, voc_yml, "vocoder_data_24khz.yml", tmp)
        finally:
            os.chdir(here)
        tts_ckpt = _copy_run(tts_expr, OUT / "tts", tmp, extra=("g2p.pkl",))
        voc_ckpt = _copy_run(voc_expr, OUT / "vocoder", tmp)
    np.savez(OUT / "reference.npz", **_reference(tts_ckpt, voc_ckpt))
    size = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"{OUT}: {size} bytes")


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main()
