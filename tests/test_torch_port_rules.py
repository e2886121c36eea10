"""Rules of the port: ``speechflow_torch`` and ``chip_smoke.py`` import
nothing of JAX, flax or the JAX package; entry points run on the GPU unless
the caller asks for the CPU, and never fall back on their own; the flagship
presets the port carries equal the YAML configs they were transcribed from."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from speechflow_torch import serving
from speechflow_torch.utils.device import resolve_device

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "speechflow_tpu")


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
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("value_select", ["default", "debug"])
@pytest.mark.parametrize("config,presets", [
    ("tts_model.yml", serving.TTS_MODEL_PRESETS),
    ("vocoder_bigvgan.yml", serving.VOCODER_BIGVGAN_PRESETS),
])
def test_presets_equal_the_yaml_configs(config, presets, value_select):
    from speechflow_tpu.io import Config

    yml = Config.create_from_file(REPO / "configs" / config,
                                  value_select=[value_select]).section("model").to_dict()
    assert presets[value_select] == yml


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
