"""What every cell's run shares: finding a cell's files by name, the set-up
clock, the weights made from the seed, the import guard, and the result line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import statistics
import sys
import typing as tp
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "speechflow_tpu")


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc, 10 ms steps)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def log(msg: str) -> None:
    """A progress line on stderr, stamped with the process's age."""
    print(f"[port_bench {process_age_s():7.2f} s] {msg}", file=sys.stderr, flush=True)


def load_json(path: tp.Union[str, Path]) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path, name: str):
    """A module from its file, by path (names of metrics hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(params: dict):
    """The traffic generator a workload's ``traffic.generator`` names
    (``port_bench/traffic/<generator>.py``)."""
    return importlib.import_module(f"port_bench.traffic.{params['generator']}")


def banned_modules() -> tp.List[str]:
    """Loaded modules whose top-level name is one the port must not load."""
    return sorted({k for k in list(sys.modules) if k.split(".", 1)[0] in BANNED})


def quartile_spread(values: tp.Sequence[float]) -> float:
    """(Q3 - Q1) / median, by ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


@dataclasses.dataclass
class Cell:
    """One cell as BENCHMARK.json and its files give it."""
    name: str
    entry: dict
    workload: dict
    config: dict
    bench: dict

    @staticmethod
    def load(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> "Cell":
        bench = load_json(bench_file)
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in {bench_file}")
        conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
        return Cell(name, entry, load_json(HERE / "workloads" / f"{name}.json"),
                    load_json(ROOT / conf["file"]), bench)

    def end_to_end(self) -> tp.List[dict]:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> tp.List[dict]:
        e2e = {m["name"] for m in self.end_to_end()}

        def here(m: dict) -> bool:
            return self.name in m["workloads"] if "workloads" in m else m["moves"] in e2e

        return [m for m in self.bench["per_layer"] if here(m)]


# -- weights from the seed -----------------------------------------------------------


def make_weights(torch, spec_module, seed: int, device,
                 vectors: tp.Mapping[str, tp.Sequence[float]]) -> tp.Dict[str, "torch.Tensor"]:
    """Float32 weights for every parameter of ``spec_module`` (built on the meta
    device), drawn on ``device`` from ``seed`` in two calls: matrices and kernels
    uniform in ±1/sqrt(fan_in) (an embedding's fan-in is its rows), biases zero,
    LayerNorm scales one, and each other vector uniform in the range
    ``vectors`` gives its name."""
    nn = torch.nn
    mats, vecs, out = [], [], {}
    for mod_name, mod in spec_module.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{p_name}" if mod_name else p_name
            if p_name == "bias":
                out[full] = torch.zeros(p.shape, device=device)
            elif isinstance(mod, nn.LayerNorm):
                out[full] = torch.ones(p.shape, device=device)
            elif p.ndim >= 2:
                fan_in = p.shape[0] if isinstance(mod, nn.Embedding) else \
                    math.prod(p.shape[1:])
                mats.append((full, tuple(p.shape), fan_in ** -0.5))
            elif p_name in vectors:
                vecs.append((full, tuple(p.shape), tuple(vectors[p_name])))
            else:
                raise KeyError(f"no rule for the vector {full}: name a range under 'vectors'")
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    for group in (mats, vecs):
        total = sum(math.prod(s) for _, s, _ in group)
        draws = torch.rand(total, generator=gen, device=device)
        at = 0
        for full, shape, arg in group:
            n = math.prod(shape)
            u = draws[at:at + n].view(shape)
            at += n
            if isinstance(arg, tuple):
                lo, hi = arg
                out[full] = u * (hi - lo) + lo
            else:
                out[full] = (u * 2.0 - 1.0) * arg
    return out


# -- the result -----------------------------------------------------------------------


def device_info(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def print_result(result: dict, checks: tp.Mapping[str, tp.Tuple[float, float]]) -> None:
    """Each compared number beside its limit as the last lines of stderr, then the
    result as the last line of stdout, its ``checks`` key last."""
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    print(json.dumps(line), flush=True)
