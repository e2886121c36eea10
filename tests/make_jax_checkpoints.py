"""Writes ``tests/data/jax_checkpoints/``: checkpoints the JAX package's trainers
write, and the JAX package's output for one sentence, so that the port (which
reads them without JAX, orbax or tensorstore) can be held to them on the CPU
and on the GPU. Run it once, by hand, where JAX runs (it is not a test):

    JAX_PLATFORMS=cpu python tests/make_jax_checkpoints.py          # all but resume/
    JAX_PLATFORMS=cpu python tests/make_jax_checkpoints.py resume   # resume/ alone
    JAX_PLATFORMS=cpu python tests/make_jax_checkpoints.py resume_adafactor

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

``python tests/make_jax_checkpoints.py resume`` writes only the checkpoints a run
resumes from, with their optimizer state (optax's), and leaves the rest as it is:

- ``resume/tts/``: the last checkpoint of ``train_tts.py -c
  configs/tts_forward.yml -vs debug`` after ``RESUME_STEPS["tts"]`` steps (bi-GRU
  encoder and decoder, bucketed pitch and energy);
- ``resume/vocoder/``: the last checkpoint of ``train_vocoder.py -c
  configs/vocoder_model.yml -vs debug`` after ``RESUME_STEPS["vocoder"]`` steps (its
  discriminator starts at step 2, at the warmup's lr of 0, and moves at step 3: its
  biases are off 0 when the run is resumed, where a conv of silence would otherwise
  give exact zeros at the leaky ReLU's kink);
- ``resume_record.npz``: JAX's next step from each, taken by the run's own trainer
  with every dropout rate 0 on its last batch (recorded: the acoustic model's inputs
  and targets, the vocoder's waveform): the losses, and for every parameter leaf up
  to ``RESUME_SAMPLES`` of its elements (their flat indices recorded) of the
  parameter and of Adam's two moments after the step, in flax's layout, with each
  model's YAML config.

Cuts (the size of a tree with its two moments): the acoustic model 32 wide with
16-wide variance predictors and 16-wide embeddings of 64 bins; the vocoder 32 wide,
the discriminators 2 channels over periods 2 and 3 and one resolution.

``python tests/make_jax_checkpoints.py resume_adafactor`` writes
``resume_adafactor/tts/``, the last checkpoint of ``train_tts.py -c
configs/tts_forward.yml -vs debug`` with ``optimizer.method: adafactor`` after
``RESUME_STEPS["tts"]`` steps, at width 128 (``encoder_dim``, ``decoder_dim``,
``postnet_dim``; the tokens' 96 and the speakers' 32 make the encoder's input
projection 128 x 128), so that its 128 x 128 Linear and its (5, 128, 128) conv
kernel are factored (ties included) and its narrower leaves are not (the variance
predictors cut to 16 wide, as ``resume/``'s, to keep the tree small); and
``resume_adafactor_record.npz``, JAX's next step as ``resume_record.npz`` records
it, with up to ``RESUME_SAMPLES`` elements of each parameter and of each of its
adafactor entries (``v_row`` and ``v_col``, or ``v``; flat indices recorded).
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


RESUME_STEPS = {"tts": 2, "vocoder": 4}
RESUME_SAMPLES = 16  # elements of each leaf kept in the record


def _resume_configs(tmp: Path) -> tp.Tuple[Path, Path]:
    tts = (REPO / "configs" / "tts_forward.yml").read_text()
    cuts = [("token_emb_dim: {default: 256, debug: 64}", "token_emb_dim: {default: 256, debug: 32}"),
            ("encoder_dim: {default: 256, debug: 64}", "encoder_dim: {default: 256, debug: 32}"),
            ("decoder_dim: {default: 256, debug: 64}", "decoder_dim: {default: 256, debug: 32}"),
            ("speaker_emb_dim: {default: 128, debug: 32}",
             "speaker_emb_dim: {default: 128, debug: 16}"),
            ("postnet_dim: {default: 256, debug: 64}", "postnet_dim: {default: 256, debug: 32}")]
    for name in ("aggregate_pitch", "aggregate_energy"):
        cuts.append((f"- {{name: {name}, as_embedding: true}}",
                     f"- {{name: {name}, as_embedding: true, dim: 16, emb_dim: 16, n_bins: 64}}"))
    cuts.append(("- {name: durations}", "- {name: durations, dim: 16}"))
    voc = (REPO / "configs" / "vocoder_model.yml").read_text()
    cuts_voc = [("dim: {default: 512, debug: 64}", "dim: {default: 512, debug: 32}"),
                ("channels: {default: 32, debug: 8}", "channels: {default: 32, debug: 2}"),
                ("periods: [2, 3, 5, 7, 11]", "periods: [2, 3]"),
                ("resolutions: [[1024, 256], [2048, 512], [512, 128]]",
                 "resolutions: [[512, 128]]")]
    for text, edits, name in ((tts, cuts, "tts_forward.yml"), (voc, cuts_voc, "vocoder_model.yml")):
        for a, b in edits:
            assert text.count(a) == 1, a
            text = text.replace(a, b)
        (tmp / name).write_text(text)
    return tmp / "tts_forward.yml", tmp / "vocoder_model.yml"


def _moments(opt_state) -> tp.Tuple[dict, dict]:
    """The (mu, nu) trees of the first Adam state in an optax state tree."""
    if isinstance(opt_state, dict):
        if "mu" in opt_state and "nu" in opt_state:
            return opt_state["mu"], opt_state["nu"]
        for v in opt_state.values():
            found = _moments(v)
            if found:
                return found
    return ()


def _sampled(prefix: str, model, optimizer, rng) -> dict:
    """Up to RESUME_SAMPLES elements of every parameter leaf and of its two moments."""
    from flax import nnx

    from speechflow_torch.convert import flatten_nnx

    params = flatten_nnx(nnx.to_pure_dict(nnx.state(model, nnx.Param)))
    mu, nu = (flatten_nnx(t) for t in _moments(nnx.to_pure_dict(nnx.state(optimizer))))
    out = {}
    for k, v in sorted(params.items()):
        idx = np.sort(rng.choice(v.size, min(v.size, RESUME_SAMPLES), replace=False))
        out[f"{prefix}/idx/{k}"] = idx.astype(np.int64)
        for name, tree in (("param", params), ("mu", mu), ("nu", nu)):
            out[f"{prefix}/{name}/{k}"] = tree[k].reshape(-1)[idx].astype(np.float32)
    return out


def _no_dropout(model) -> None:
    from flax import nnx

    for _, node in nnx.iter_graph(model):
        if isinstance(node, nnx.Dropout):
            node.rate = 0.0
        elif isinstance(node, nnx.MultiHeadAttention):
            node.dropout_rate = 0.0


def resume_fixture() -> None:
    """``resume/`` and ``resume_record.npz`` (see the module's docstring)."""
    import dataclasses

    from speechflow_tpu.models.tts.batch_processor import TTSBatchProcessor
    from speechflow_tpu.scripts import train_tts, train_vocoder
    from speechflow_tpu.training.gan_trainer import GANTrainer
    from speechflow_tpu.training.trainer import Trainer

    out_dir = OUT / "resume"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    record: tp.Dict[str, np.ndarray] = {}
    rng = np.random.default_rng(0)
    here = Path.cwd()
    seen: dict = {}
    steps = {Trainer: Trainer.training_step, GANTrainer: GANTrainer.training_step}

    def recording(cls):
        def step(self, batch):
            seen[cls] = (self, batch)
            return steps[cls](self, batch)
        return step

    with tempfile.TemporaryDirectory(prefix="jax_resume_") as td:
        tmp = Path(td)
        tts_yml, voc_yml = _resume_configs(tmp)
        for cls in steps:
            cls.training_step = recording(cls)
        try:
            runs = {}
            for kind, script, yml, data in (("tts", train_tts, tts_yml, "tts_data_24khz.yml"),
                                            ("vocoder", train_vocoder, voc_yml,
                                             "vocoder_data_24khz.yml")):
                os.chdir(tmp)
                expr = Path(script.main([
                    "-c", str(yml), "-cd", str(REPO / "configs" / data), "-vs", "debug",
                    "--max_steps", str(RESUME_STEPS[kind]), "--data_root", str(SEGS),
                    "--platform", "cpu"])).resolve()
                os.chdir(here)
                ckpt = expr / "checkpoints" / f"step_{RESUME_STEPS[kind]:09d}"
                shutil.copytree(ckpt, out_dir / kind / ckpt.name)
                record[f"{kind}/config_yaml"] = np.array(yml.read_text())
                runs[kind] = seen[Trainer if kind == "tts" else GANTrainer]
        finally:
            os.chdir(here)
            for cls, fn in steps.items():
                cls.training_step = fn

        trainer, batch = runs["tts"]
        _no_dropout(trainer.model)
        inputs, targets = TTSBatchProcessor()(batch)
        for tag, obj in (("in", inputs), ("tgt", targets)):
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                if v is not None and not isinstance(v, (dict, int)):
                    record[f"tts/{tag}/{f.name}"] = np.asarray(v)
        losses = trainer.training_step(batch)
        record.update({f"tts/loss/{k}": np.asarray(float(v)) for k, v in losses.items()})
        record.update(_sampled("tts", trainer.model, trainer.optimizer, rng))

        gan, batch = runs["vocoder"]
        wave = np.asarray(batch.collated_samples.waveform if hasattr(batch, "collated_samples")
                          else batch.waveform, np.float32)
        record["vocoder/waveform"] = wave
        losses = gan.training_step({"waveform": wave})
        record.update({f"vocoder/loss/{k}": np.asarray(float(v)) for k, v in losses.items()})
        record.update(_sampled("vocoder/gen", gan.generator, gan.gen_opt, rng))
        record.update(_sampled("vocoder/disc", gan.discriminator, gan.disc_opt, rng))
    np.savez_compressed(OUT / "resume_record.npz", **record)
    size = sum(p.stat().st_size for p in out_dir.rglob("*") if p.is_file())
    print(f"{out_dir}: {size} bytes; {OUT / 'resume_record.npz'}: "
          f"{(OUT / 'resume_record.npz').stat().st_size} bytes")


ADAFACTOR_WIDTHS = {"token_emb_dim": 96, "encoder_dim": 128, "decoder_dim": 128,
                    "postnet_dim": 128}


def _adafactor_config(tmp: Path) -> Path:
    text = (REPO / "configs" / "tts_forward.yml").read_text()
    edits = [("  method: adamw\n", "  method: adafactor\n")]
    edits += [(f"{k}: {{default: 256, debug: 64}}", f"{k}: {{default: 256, debug: {w}}}")
              for k, w in ADAFACTOR_WIDTHS.items()]
    for name in ("aggregate_pitch", "aggregate_energy"):
        edits.append((f"- {{name: {name}, as_embedding: true}}",
                      f"- {{name: {name}, as_embedding: true, dim: 16, emb_dim: 16, n_bins: 64}}"))
    edits.append(("- {name: durations}", "- {name: durations, dim: 16}"))
    for a, b in edits:
        assert text.count(a) == 1, a
        text = text.replace(a, b)
    (tmp / "tts_forward.yml").write_text(text)
    return tmp / "tts_forward.yml"


def _factored_state(opt_state) -> dict:
    """The first adafactor ``FactoredState`` (v_row, v_col, v) in an optax state tree."""
    if isinstance(opt_state, dict):
        if {"v_row", "v_col", "v"} <= set(opt_state):
            return opt_state
        for v in opt_state.values():
            found = _factored_state(v)
            if found:
                return found
    return {}


def resume_adafactor_fixture() -> None:
    """``resume_adafactor/`` and ``resume_adafactor_record.npz`` (see the module's
    docstring)."""
    import dataclasses

    from flax import nnx

    from speechflow_tpu.models.tts.batch_processor import TTSBatchProcessor
    from speechflow_tpu.scripts import train_tts
    from speechflow_tpu.training.trainer import Trainer
    from speechflow_torch.convert import flatten_nnx

    out_dir = OUT / "resume_adafactor"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    record: tp.Dict[str, np.ndarray] = {}
    rng = np.random.default_rng(0)
    here = Path.cwd()
    seen: dict = {}
    step_fn = Trainer.training_step

    def recording(self, batch):
        seen["run"] = (self, batch)
        return step_fn(self, batch)

    steps = RESUME_STEPS["tts"]
    with tempfile.TemporaryDirectory(prefix="jax_resume_adafactor_") as td:
        tmp = Path(td)
        yml = _adafactor_config(tmp)
        Trainer.training_step = recording
        try:
            os.chdir(tmp)
            expr = Path(train_tts.main([
                "-c", str(yml), "-cd", str(REPO / "configs" / "tts_data_24khz.yml"),
                "-vs", "debug", "--max_steps", str(steps), "--data_root", str(SEGS),
                "--platform", "cpu"])).resolve()
        finally:
            os.chdir(here)
            Trainer.training_step = step_fn
        ckpt = expr / "checkpoints" / f"step_{steps:09d}"
        shutil.copytree(ckpt, out_dir / "tts" / ckpt.name)
        record["tts/config_yaml"] = np.array(yml.read_text())

    trainer, batch = seen["run"]
    _no_dropout(trainer.model)
    inputs, targets = TTSBatchProcessor()(batch)
    for tag, obj in (("in", inputs), ("tgt", targets)):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is not None and not isinstance(v, (dict, int)):
                record[f"tts/{tag}/{f.name}"] = np.asarray(v)
    losses = trainer.training_step(batch)
    record.update({f"tts/loss/{k}": np.asarray(float(v)) for k, v in losses.items()})
    params = flatten_nnx(nnx.to_pure_dict(nnx.state(trainer.model, nnx.Param)))
    state = _factored_state(nnx.to_pure_dict(nnx.state(trainer.optimizer)))
    entries = {k: flatten_nnx(state[k]) for k in ("v_row", "v_col", "v")}
    factored = 0
    for k, v in sorted(params.items()):
        kept = ("v_row", "v_col") if entries["v_row"][k].shape != (1,) else ("v",)
        for name, arr in (("param", v), *((e, entries[e][k]) for e in kept)):
            idx = np.sort(rng.choice(arr.size, min(arr.size, RESUME_SAMPLES), replace=False))
            record[f"tts/{name}/idx/{k}"] = idx.astype(np.int64)
            record[f"tts/{name}/{k}"] = arr.reshape(-1)[idx].astype(np.float32)
        factored += kept != ("v",)
    np.savez_compressed(OUT / "resume_adafactor_record.npz", **record)
    size = sum(p.stat().st_size for p in out_dir.rglob("*") if p.is_file())
    print(f"{out_dir}: {size} bytes, {factored} of {len(params)} leaves factored; "
          f"{OUT / 'resume_adafactor_record.npz'}: "
          f"{(OUT / 'resume_adafactor_record.npz').stat().st_size} bytes")


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
    if sys.argv[1:] == ["resume"]:
        resume_fixture()
    elif sys.argv[1:] == ["resume_adafactor"]:
        resume_adafactor_fixture()
    else:
        main()
