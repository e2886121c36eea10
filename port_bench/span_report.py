#!/usr/bin/env python3
"""The program's spans over one traced run of one cell, with spans on.

    python3 port_bench/span_report.py --workload <name> --seed <n> --seconds <s>

Runs the cell's driver as ``run.py --trace 1`` does, with ``MODEL_PROFILING``
on: in the untraced window each span of ``speechflow_torch`` records CUDA
events, and in the traced calls it is a range on the profiler's clock. Prints
one JSON object as the last line of standard output:

- ``window``: each tag's spans in the window (the ``attempted`` calls or
  micro-batches that start after set-up): count, and device and host ms, each
  in total and a call;
- ``trace``: every per-layer metric of the cell, read from the traced calls as
  ``run.py`` reads them, and ``by_span`` (``port_bench/spans.py``);
- ``step_idle_share`` (training): 1 - the device time launched inside
  ``gan.step`` in the traced cycle, a micro-batch, over the mean device time of
  ``gan.step`` in the window by its events, in %: the device's idle within a
  step without the profiler's cost on the host;
- the card's name and power limit.

It reads the program's span record (``utils/profiler.py::record_spans``), so it
runs on a checkout whose program has spans; the benchmark's cells do not run it.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from port_bench import run as bench_run  # noqa: E402

TOP = {"serve": "tts.inference", "gan_train": "gan.step"}


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except OSError:
        return "unknown"


def window_records(records, top: str, window_start: float, attempted: int):
    """The records of the window: from the ``top`` span that starts nearest to
    ``window_start`` (a clock read to ~10 ms) to the start of the ``top`` span
    after ``attempted`` of them."""
    tops = sorted(r.start for r in records if r.tag == top)
    first = min(range(len(tops)), key=lambda i: abs(tops[i] - window_start))
    end = tops[first + attempted] if len(tops) > first + attempted else float("inf")
    return [r for r in records if tops[first] <= r.start < end]


def summarise(records, per: int) -> dict:
    by_tag = collections.defaultdict(list)
    for r in records:
        by_tag[r.tag].append(r)
    out = {}
    for tag, rs in sorted(by_tag.items()):
        dev = sum(r.device_s or 0.0 for r in rs) * 1e3
        host = sum(r.host_s for r in rs) * 1e3
        out[tag] = {"n": len(rs), "device_ms": dev, "host_ms": host,
                    "device_ms_each": dev / per, "host_ms_each": host / per}
    return out


def report(cell, seed: int, seconds: float, device) -> dict:
    """Drive ``cell`` with spans on and read them (see the module docstring)."""
    import torch  # noqa: F401  (the drivers' own import, after the environment)

    from port_bench import compare, core, spans
    from speechflow_torch.utils import profiler as P

    kind = cell.workload["driver"]
    driver = importlib.import_module(f"port_bench.drivers.{kind}")
    was = P.set_model_profiling(True)
    clock0, age0 = time.perf_counter(), core.process_age_s()
    try:
        with P.record_spans() as records:
            res = driver.run(cell, seed, seconds, True, device)
    finally:
        P.set_model_profiling(was)
    layer = res["layer"]
    n = res["attempted"]
    in_window = window_records(records, TOP[kind], res["setup_s"] - age0 + clock0, n)
    window = summarise(in_window, n)
    metrics = {}
    for m in cell.per_layer():
        reader = core.load_file(core.HERE / "metrics" / f"{m['name']}.py", f"m_{len(metrics)}")
        metrics[m["name"]] = reader.read(layer)
    tr = layer["trace"]
    out = {"workload": cell.name, "seed": seed,
           "correct": compare.judge(res["numbers"], cell.workload["limits"])[0],
           "attempted": n, "e2e": res["e2e"], "window": window,
           "trace": {"metrics": metrics, "busy_s": tr.busy_s, "window_s": tr.window_s,
                     "host_s": tr.host_s, "by_span": spans.by_span(tr)}}
    step = window.get("gan.step")
    if step and step["device_ms_each"] > 0:
        busy = spans.under_ranges_s(tr, ["gan.step"], any_thread=True) / layer["micro_batches"]
        out["step_idle_share"] = 100.0 * (1.0 - 1e3 * busy / step["device_ms_each"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    bench_run._environment()
    import torch

    from port_bench import core

    if not torch.cuda.is_available():
        print("span_report: no CUDA device", file=sys.stderr)
        return 2
    out = report(core.Cell.load(args.workload), args.seed, args.seconds,
                 torch.device("cuda"))
    out["card"] = _card()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
