"""A workload file, a traffic generator and a metric file dropped into a copy
of the benchmark are found by their names (in BENCHMARK.json, and the
workload's ``traffic.generator``), with no edit to any code."""

import json
import shutil
import subprocess
import sys

import debug_cells

ROOT = debug_cells.ROOT


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "cfm-bigvgan.b16-new", "config": "cfm-dit-bigvgan",
                               "traffic": "b16-new", "chips": 1, "why": "a later cell"})
    bench["per_layer"].append({"name": "calls_seen.serve", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "serving program",
                               "moves": "synth_audio_s_per_s",
                               "workloads": ["cfm-bigvgan.b16-new"]})
    for m in bench["end_to_end"]:
        if m["name"] == "synth_audio_s_per_s":
            m["workloads"].append("cfm-bigvgan.b16-new")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    wl = json.loads((ROOT / "port_bench/workloads/cfm-bigvgan.b32-long.json").read_text())
    wl["traffic"]["batch"] = 16
    wl["traffic"]["generator"] = "new_text"
    (tmp_path / "port_bench/traffic/new_text.py").write_text(
        "def make_calls(params, seed, model):\n    return ['call'] * params['batch']\n")
    (tmp_path / "port_bench/workloads/cfm-bigvgan.b16-new.json").write_text(json.dumps(wl))
    (tmp_path / "port_bench/metrics/calls_seen.serve.py").write_text(
        "def read(layer):\n    return len(layer['acoustic_ms'])\n")
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from port_bench import core\n"
        "cell = core.Cell.load('cfm-bigvgan.b16-new')\n"
        "assert cell.workload['traffic']['batch'] == 16\n"
        "tr = cell.workload['traffic']\n"
        "assert len(core.traffic(tr).make_calls(tr, 1, {})) == 16\n"
        "names = [m['name'] for m in cell.per_layer()]\n"
        "assert names == ['calls_seen.serve'], names\n"
        "reader = core.load_file(core.HERE / 'metrics' / 'calls_seen.serve.py', 'm')\n"
        "print(reader.read({'acoustic_ms': [1.0, 2.0, 3.0]}), "
        "[m['name'] for m in cell.end_to_end()])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "3 ['setup_s', 'synth_audio_s_per_s']"
