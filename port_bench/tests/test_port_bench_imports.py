"""The reference imports nothing of the program, and a run refuses to print a
result once a module of JAX or of the JAX package is loaded (compared by whole
top-level names: the port's own name begins with the JAX package's)."""

import subprocess
import sys

import debug_cells

ROOT = str(debug_cells.ROOT)


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)


def test_the_reference_loads_no_module_of_the_program():
    out = _python(
        "import sys; sys.path.insert(0, '.')\n"
        "import port_bench.reference.tts, port_bench.reference.vocoder, "
        "port_bench.reference.gan, port_bench.reference.nn, port_bench.compare, "
        "port_bench.roofline, port_bench.traffic.tts_text, port_bench.traffic.audio_chunks\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('speechflow_torch', 'speechflow_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "print(bad)\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_guard_names_whole_top_level_names():
    out = _python(
        "import sys, types; sys.path.insert(0, '.')\n"
        "from port_bench import core\n"
        "sys.modules['speechflow_torch_like'] = types.ModuleType('x')\n"
        "sys.modules['speechflow_torch.ops'] = types.ModuleType('y')\n"
        "sys.modules['jaxtyping'] = types.ModuleType('z')\n"
        "assert core.banned_modules() == [], core.banned_modules()\n"
        "sys.modules['jax.numpy'] = types.ModuleType('j')\n"
        "sys.modules['speechflow_tpu'] = types.ModuleType('t')\n"
        "print(core.banned_modules())\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['jax.numpy', 'speechflow_tpu']"


def test_a_run_without_a_card_fails():
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "cfm-bigvgan.b32-long", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
