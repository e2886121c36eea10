"""Rules of the port: ``speechflow_torch`` and ``chip_smoke.py`` import
nothing of JAX, flax or the JAX package, and none of the libraries that
machine lacks for its checkpoints and configs (PyYAML, orbax, tensorstore,
zstandard); entry points run on the GPU unless the caller asks for the CPU, and
never fall back on their own; the serving presets the port carries equal the
YAML configs they were transcribed from."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from speechflow_torch import serving
from speechflow_torch.utils.device import resolve_device

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
SEGS = REPO / "tests" / "data" / "SEGS"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "speechflow_tpu", "yaml",
             "tensorstore", "zstandard", "zmq")


def _port_files():
    """The package, the smoke run and the GPU tests: all run where JAX is absent."""
    return sorted((REPO / "speechflow_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda_kernels.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax():
    files = _port_files()
    assert len(files) > 20
    bad = {str(p.relative_to(REPO)): sorted(set(_imported_roots(p)) & set(FORBIDDEN))
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


# modules added with the folded head, the DSP ops, the ISTFT vocoder, the
# vocoder eval interface, the TTS eval interface with its text path, the
# vocoder's GAN training, the acoustic model's training with its data
# plane, XTTS serving with the serving entry points, the data-parallel
# training with its data server (no pyzmq: the data plane is the standard
# library's), and the training API's tail (the profiler, the data core, the
# io and utils helpers): each must exist and be held to the rules above
NEW_MODULES = ("ops/stft.py", "ops/mel.py", "ops/folded.py",
               "models/vocoder/folded_head.py", "models/vocoder/feature_extractors.py",
               "io/audio.py", "training/saver.py", "utils/state_io.py",
               "interface/vocoder_interface.py",
               "data/processors/text.py", "data/processors/text_norm.py",
               "data/processors/ling.py", "data/processors/ssml.py",
               "data/core/datasample.py", "data/core/components.py", "data/collate.py",
               "utils/pad.py", "models/tts/batch_processor.py", "models/g2p/model.py",
               "interface/tts_interface.py",
               "ops/cqt.py", "ops/pitch.py", "models/vocoder/discriminators.py",
               "models/vocoder/extra_discriminators.py", "models/vocoder/criterion.py",
               "models/vocoder/batch_processor.py", "models/vocoder/metrics.py",
               "models/vocoder/pesq.py", "training/lr_schedulers.py", "training/optimizer.py",
               "training/trainer.py", "training/gan_trainer.py", "data/parsers.py",
               "data/processors/audio.py", "data/processors/singletons.py",
               "data/samplers.py", "io/flist.py", "utils/init.py", "scripts/common.py",
               "scripts/train_vocoder.py",
               "io/seg.py", "io/timestamps.py", "data/processors/np_dsp.py",
               "data/processors/spectral.py", "data/processors/tts.py",
               "data/processors/__init__.py", "models/tts/criterion.py",
               "models/tts/model.py", "models/tts/decoders.py", "models/tts/common.py",
               "models/tts/encoders.py", "models/tts/predictors.py",
               "models/tts/variance_adaptor.py", "models/tts/data_types.py",
               "models/layers.py", "ops/attention.py", "training/losses/__init__.py",
               "training/losses/base.py", "training/losses/zoo.py", "scripts/train_tts.py",
               "models/tts/ar_decoders.py", "models/tts/xtts.py", "models/codec/__init__.py",
               "models/codec/rvq.py", "interface/xtts_interface.py", "interface/__init__.py",
               "scripts/export.py", "app/__init__.py", "app/demo_server.py",
               "io/zstd.py", "io/ocdbt.py", "io/orbax.py", "io/config.py", "ops/mas.py",
               "ops/length_regulator.py", "training/optax_state.py",
               "models/vocoder/nsf.py", "models/vocoder/tts_features.py",
               "models/vocoder/mos_proxy.py", "models/vocoder/heads.py",
               "models/vocoder/backbones.py", "models/vocoder/model.py",
               "models/aligner/__init__.py", "models/aligner/flows.py",
               "models/aligner/model.py", "models/aligner/criterion.py",
               "models/aligner/batch_processor.py", "scripts/train_aligner.py",
               "annotator/__init__.py", "annotator/align.py",
               "scripts/train_g2p.py", "models/g2p/__init__.py", "models/ssl/__init__.py",
               "models/ssl/cpc.py", "models/denoiser/__init__.py", "models/denoiser/demucs.py",
               "models/vocoder/denoiser.py", "models/pitch/__init__.py",
               "models/pitch/crepe.py", "models/asr/__init__.py", "models/asr/ctc_model.py",
               "annotator/asr.py", "data/processors/embeddings.py",
               "examples/__init__.py", "examples/codec/train.py",
               "examples/biometric/train.py",
               "data/core/registry.py", "data/core/processor.py", "data/processors/audio.py",
               "data/processors/augment.py", "data/processors/lpc.py",
               "data/processors/signal1d.py", "io/codecs.py", "scripts/dump.py",
               "scripts/prosody_annotation.py", "scripts/data_pipeline_check.py",
               "scripts/eval_tts.py", "training/callbacks.py", "utils/plotting.py",
               "data/core/parser.py", "annotator/text_alignment.py",
               "annotator/seg_generator.py", "annotator/cloud_asr.py",
               "annotator/prepare_datasets.py", "annotator/runner.py",
               "examples/mnist/__init__.py", "examples/mnist/train.py",
               "concurrency/__init__.py", "concurrency/process_worker.py",
               "concurrency/context.py",
               "logging/__init__.py", "logging/server.py", "logging/utils.py",
               "server/__init__.py", "server/transport.py", "server/server.py",
               "server/worker.py", "server/loader.py", "server/client.py", "server/proxy.py",
               "server/helpers.py", "parallel/__init__.py", "parallel/distributed.py",
               "parallel/mesh.py",
               "utils/profiler.py", "data/core/batch.py", "data/core/dataset.py",
               "data/core/singleton.py", "io/serialize.py", "utils/dictutils.py",
               "utils/seed.py", "utils/misc.py", "utils/masks.py", "ops/signal.py")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_no_jax(module):
    path = REPO / "speechflow_torch" / module
    assert path in _port_files()
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    """Every module of the package, imported in a fresh interpreter."""
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
            for p in sorted((REPO / "speechflow_torch").rglob("*.py"))]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.build_flagship("debug")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.build_toy()
    assert resolve_device("cpu") == torch.device("cpu")


def test_tts_data_preset_equals_the_yaml_config():
    """The data config's pipeline sections, as ``flagship_payload`` carries them."""
    from speechflow_tpu.io import Config

    yml = Config.create_from_file(REPO / "configs" / "tts_data_24khz.yml",
                                  value_select=["default"]).to_dict()
    preset = serving.TTS_DATA_CONFIG
    assert preset == {k: yml[k] for k in preset}


@pytest.mark.parametrize("value_select", ["default", "debug"])
@pytest.mark.parametrize("config,presets", [
    ("tts_model.yml", serving.TTS_MODEL_PRESETS),
    ("vocoder_bigvgan.yml", serving.VOCODER_BIGVGAN_PRESETS),
    ("vocoder_model.yml", serving.VOCODER_MODEL_PRESETS),
])
def test_presets_equal_the_yaml_configs(config, presets, value_select):
    from speechflow_tpu.io import Config

    yml = Config.create_from_file(REPO / "configs" / config,
                                  value_select=[value_select]).section("model").to_dict()
    assert presets[value_select] == yml


def test_serving_entry_points_run_on_the_gpu_unless_asked(monkeypatch, tmp_path):
    """The XTTS interface, the demo server's CLI and ``eval_tts`` raise without
    CUDA and without ``device="cpu"``, before they read a checkpoint's weights."""
    from speechflow_torch.app import demo_server
    from speechflow_torch.interface.xtts_interface import XTTSEvaluationInterface
    from speechflow_torch.scripts import eval_tts

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        XTTSEvaluationInterface(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_tts.main(["--tts_ckpt", str(REPO / "tests" / "data" / "jax_checkpoints" / "tts"),
                       "--out", str(tmp_path)])
    monkeypatch.setattr(demo_server, "make_server", lambda *a, **k: pytest.fail("served"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo_server.main(["--tts_ckpt", str(tmp_path), "--vocoder_ckpt", str(tmp_path)])


def test_train_entry_point_runs_on_the_cpu_only_when_asked(monkeypatch, tmp_path):
    """``train_vocoder.main`` at the debug presets on the CPU writes a checkpoint
    the port loads; without CUDA and without ``--device cpu`` it raises."""
    from speechflow_torch.scripts import train_vocoder
    from speechflow_torch.training.saver import ExperimentSaver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_vocoder.main(["-vs", "debug", "--experiment_dir", str(tmp_path / "gpu")])
    expr = train_vocoder.main(["-vs", "debug", "--max_steps", "2", "--device", "cpu",
                               "--experiment_dir", str(tmp_path), "--data_root", str(SEGS)])
    ckpt = ExperimentSaver.get_last_checkpoint(expr)
    tree, payload = ExperimentSaver.load_checkpoint(ckpt)
    assert ckpt.name == "step_000000002" and set(tree["model"]) == {"generator",
                                                                    "discriminator"}
    assert payload["pipeline_info"]["dataset_sizes"] == {"train": 6, "test": 6}


def test_vocoder_model_recipe_trains_on_the_cpu(tmp_path):
    """``train_vocoder -c configs/vocoder_model.yml -vs debug`` (mel features,
    Vocos backbone, ISTFT head, MPD + MRD) trains 2 steps on the CPU; the
    checkpoint holds that model and serves through the vocoder interface."""
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.scripts import train_vocoder
    from speechflow_torch.training.saver import ExperimentSaver

    expr = train_vocoder.main(["-c", "configs/vocoder_model.yml", "-vs", "debug",
                               "--max_steps", "2", "--device", "cpu",
                               "--experiment_dir", str(tmp_path), "--data_root", str(SEGS)])
    ckpt = ExperimentSaver.get_last_checkpoint(expr)
    tree, payload = ExperimentSaver.load_checkpoint(ckpt)
    assert ckpt.name == "step_000000002" and int(tree["step"]) == 2
    assert payload["model_params"]["head"] == "istft" and payload["model_params"]["dim"] == 64
    assert "resolutions" in payload["model_config_text"]
    assert set(tree["model"]["discriminator"]["mrd"]) == {"discs"}
    vi = VocoderEvaluationInterface.from_checkpoint(tree, payload, device="cpu")
    mel = torch.randn(1, 20, payload["model_params"]["n_mels"])
    wav = vi.synthesize(mel).data
    assert wav.shape[-1] == 19 * 256 and np.isfinite(wav).all()


def test_tts_train_entry_point_runs_on_the_cpu_only_when_asked(monkeypatch, tmp_path):
    """``train_tts.main`` at the debug presets on the CPU writes a checkpoint
    (with the pipeline info and model params) that
    ``TTSEvaluationInterface.from_checkpoint`` loads and synthesizes text
    with; without CUDA and without ``--device cpu`` it raises."""
    from speechflow_torch.interface.tts_interface import TTSEvaluationInterface
    from speechflow_torch.scripts import train_tts
    from speechflow_torch.training.saver import ExperimentSaver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_tts.main(["-vs", "debug", "--experiment_dir", str(tmp_path / "gpu")])
    expr = train_tts.main(["-vs", "debug", "--max_steps", "2", "--device", "cpu",
                           "--experiment_dir", str(tmp_path), "--data_root", str(SEGS)])
    ckpt = ExperimentSaver.get_last_checkpoint(expr)
    tree, payload = ExperimentSaver.load_checkpoint(ckpt)
    assert ckpt.name == "step_000000002" and tree["opt"] is not None
    assert payload["pipeline_info"]["dataset_sizes"] == {"train": 6, "test": 6}
    assert payload["model_params"]["n_symbols"] == len(
        payload["pipeline_info"]["alphabet"]["symbols"])
    ti = TTSEvaluationInterface.from_checkpoint(tree, payload, ckpt_path=ckpt, device="cpu")
    out = ti.synthesize("It rained. Stop!", generator=torch.Generator().manual_seed(0))
    assert out.spectrogram.shape[:2] == (2, 2) and bool(torch.isfinite(out.spectrogram).all())
    assert ti.pipeline.handler_names == ["text_to_transcription", "add_xpbert_feat"]


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """Without CUDA (here) it exits non-zero and prints no result; alone in
    a directory, without the package beside it, likewise."""
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
