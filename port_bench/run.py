#!/usr/bin/env python3
"""One run of one benchmark cell of speechflow_torch on the card.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration; its workload file
(``port_bench/workloads/<name>.json``) names the driver of the program's entry
(``port_bench/drivers/<driver>.py``), the traffic, and the limit of each number
the comparison with the plain reference reads. With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
each read by ``port_bench/metrics/<metric>.py``. The last line of standard
output is the result as one JSON object. Without a CUDA device the run fails.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no library loads JAX for us."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(HERE.parent) not in sys.path:
        sys.path.insert(0, str(HERE.parent))


def execute(cell, seed: int, seconds: float, trace: bool, device, chips: int = 1):
    """Drive the cell, judge it, read its metrics: (result dict, checks)."""
    import torch

    from port_bench import compare, core

    driver = importlib.import_module(f"port_bench.drivers.{cell.workload['driver']}")
    res = driver.run(cell, seed, seconds, trace, device)
    correct, checks = compare.judge(res["numbers"], cell.workload["limits"])
    dev = core.device_info(torch, chips)
    dev["memory_peak_bytes"] = int(res["memory_peak_bytes"])
    metrics = {}
    if trace:
        tr = res["layer"]["trace"]
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        for m in cell.per_layer():
            reader = core.load_file(core.HERE / "metrics" / f"{m['name']}.py",
                                    f"port_bench_metric_{len(metrics)}")
            value = reader.read(res["layer"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(res["e2e"], setup_s=res["setup_s"])
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end()}
    result = {"correct": bool(correct), "attempted": int(res["attempted"]),
              "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = res["layer"]["trace"].breakdown()
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from port_bench import core

    core.log("torch imported")
    cell = core.Cell.load(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = execute(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda"), chips)
    banned = core.banned_modules()
    if banned:
        print(f"port_bench: the run loaded modules it must not: {banned}", file=sys.stderr)
        return 3
    core.print_result(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
