"""The benchmark's cells at debug widths, for the CPU tests: every kind of layer
kept, each width cut, the CUDA calls of the drivers made host no-ops."""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import core  # noqa: E402


class HostEvent:
    """``torch.cuda.Event`` on the host clock."""

    def __init__(self, enable_timing: bool = False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def host_cuda(monkeypatch, torch) -> None:
    """The drivers' CUDA calls as no-ops on the host (the tests skip the run's
    look for a card and drive the rest of it)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, **k: "host")


def serve_cell(name: str = "cfm-bigvgan.b32-long") -> core.Cell:
    """A serving cell of BENCHMARK.json with the flagship cut to debug widths
    (depth, heads' layout, CFG, the head's three MRF kernels kept)."""
    return _serve_debug(_cell(name, "cfm-dit-bigvgan"))


def _cell(name: str, config: str) -> core.Cell:
    """A cell from its workload and configuration files, whether or not
    BENCHMARK.json lists it yet."""
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    entry = {"name": name, "config": config, "traffic": name.split(".", 1)[1], "chips": 1}
    return core.Cell(name, entry,
                     copy.deepcopy(core.load_json(core.HERE / "workloads" / f"{name}.json")),
                     copy.deepcopy(core.load_json(core.HERE / "configs" / f"{config}.json")),
                     bench)


def _serve_debug(cell: core.Cell) -> core.Cell:
    cfg, wl = cell.config, cell.workload
    cfg["acoustic_model"].update(token_emb_dim=32, encoder_dim=48, encoder_heads=4,
                                 decoder_dim=48, decoder_heads=4, encoder_layers=2,
                                 decoder_layers=2, speaker_emb_dim=16, postnet_dim=32,
                                 cfm_n_timesteps=3)
    cfg["vocoder"].update(dim=32, n_layers=2, upsample_rates=[8, 8, 4], upsample_channels=32,
                          resblock_kernel_sizes=[3, 7, 11])
    cfg["fold_inference"] = {"target": 32, "threshold": 16}
    cfg["weights"]["frames_per_token"] = 4
    tr = wl["traffic"]
    tr["t_out"] = 48
    tr["pool"] = min(tr["pool"], 8)
    tr["batch"] = 3
    tr["tokens"] = {"fixed": 6} if "fixed" in tr["tokens"] else \
        {"lognormal": {"median": 4, "sigma": 0.5, "min": 2, "max": 8}}
    tr["trace_calls"] = 1
    return cell


def gan_cell() -> core.Cell:
    """The GAN training cell at debug widths: B2 x 0.35 s chunks, 2 micro-batches
    an optimizer step."""
    cell = _cell("bigvgan-gan.b32-1s", "bigvgan-gan-train")
    cfg, wl = cell.config, cell.workload
    cfg["generator"].update(dim=32, n_layers=2, upsample_rates=[8, 8, 4], upsample_channels=32,
                            resblock_kernel_sizes=[3, 7])
    cfg["discriminator"]["channels"] = 4
    cfg["batch"] = 2
    cfg["data"]["chunk_duration"] = 0.35
    cfg["optimizer"]["grad_accum"] = 2
    cfg["optimizer"]["lr_schedule_kwargs"] = {"warmup_steps": 2, "decay_steps": 100}
    wl["traffic"]["micro_batches"] = 12
    return cell
