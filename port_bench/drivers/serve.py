"""Driver of the serving program: ``speechflow_torch.serving.synthesize`` over
the acoustic model and the vocoder a configuration describes, in a closed loop
of the calls its traffic makes.

Set-up: the weights from the seed (on the device, float32), the duration
predictor's output bias set so that the cell's rows hold the same valid frames
for every seed (``make_weights``), the
program built from them (the vocoder's head folded after the weights are in,
then cast to the configuration's dtype), each call of the pool run once, and
the CFM noise of every call drawn on the device. Window: calls back to back,
each ended by a synchronise, until ``seconds`` have passed; every call counts.
A traced run then profiles ``trace_calls`` more calls. Last, with the program
freed, the reference judges the sampled calls.

The traffic module the workload's ``traffic.generator`` names gives
``make_calls(params, seed, model)``: the pool of calls, each with ``inputs``
(host tensors of ``TTSForwardInput``'s fields), ``lengths`` (valid tokens a
row) and ``rows``.
"""

from __future__ import annotations

import gc
import time
import typing as tp

import numpy as np
import torch

from port_bench import compare, core
from port_bench import trace as T
from port_bench.reference import nn as R
from port_bench.reference.tts import AcousticModel
from port_bench.reference.vocoder import Vocoder


class Tap:
    """Wraps a program entry: keeps its last output and, when timing, CUDA events
    around each call (device ms, read after the window)."""

    def __init__(self, fn: tp.Callable, timing: bool):
        self.fn, self.timing = fn, timing
        self.events: tp.List[tp.Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.last = None

    def __call__(self, *args, **kwargs):
        if self.timing:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        self.last = self.fn(*args, **kwargs)
        if self.timing:
            end.record()
            self.events.append((start, end))
        return self.last

    def ms(self) -> tp.List[float]:
        return [s.elapsed_time(e) for s, e in self.events]


def reference_models(cfg: dict, weights: tp.Tuple[dict, dict], device):
    """The reference acoustic model and vocoder holding the benchmark's float32 weights."""
    with torch.device("meta"):
        am, voc = AcousticModel(cfg["acoustic_model"]), Vocoder(cfg["vocoder"])
    am.load_state_dict(weights[0], assign=True)
    voc.load_state_dict(weights[1], assign=True)
    return am, voc


def to_device(inputs: tp.Mapping[str, torch.Tensor], device) -> dict:
    return {k: v.to(device) for k, v in inputs.items()}


def make_weights(cfg: dict, seed: int, device, calls: tp.Sequence,
                 t_out: int) -> tp.Tuple[dict, dict]:
    """(acoustic model, vocoder) weights from the seed, the duration bias set on
    the cell's rows (reference, float32): the smallest bias at which the rows'
    rounded durations, each row cut at ``t_out``, add up to the frames a row of n
    tokens would take at ``frames_per_token``, cut at ``frames_cap`` of ``t_out``.
    So every seed's calls hold the same valid frames, whatever the seed's
    weights make of the durations' spread."""
    with torch.device("meta"):
        am_spec, voc_spec = AcousticModel(cfg["acoustic_model"]), Vocoder(cfg["vocoder"])
    w = cfg["weights"]
    w_am = core.make_weights(torch, am_spec, seed, device, w["vectors"])
    w_voc = core.make_weights(torch, voc_spec, seed + 1, device, w["vectors"])
    with torch.device("meta"):
        am = AcousticModel(cfg["acoustic_model"])
    am.load_state_dict(w_am, assign=True)
    rows = []
    with torch.no_grad(), compare.no_tf32():
        for c in calls:
            x = to_device(c.inputs, device)
            _, _, log_d = am.infer(x, R.Precision.reference())  # the bias is still 0
            rows.append((log_d.float(), R.seq_mask(x["transcription_lengths"], log_d.shape[1])))
    target = sum(min(w["frames_per_token"] * n, w["frames_cap"] * t_out)
                 for c in calls for n in c.lengths)

    def frames(b: float) -> float:
        return sum(float(torch.clamp(torch.round(torch.clamp(torch.expm1(s + b), min=0.0) * m)
                                     .sum(-1), max=t_out).sum()) for s, m in rows)

    lo, hi = -10.0, 10.0
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        lo, hi = (lo, mid) if frames(mid) >= target else (mid, hi)
    w_am["variance_adaptor.predictors.durations.out.bias"].fill_(hi)
    return w_am, w_voc


def build_program(cfg: dict, weights: tp.Tuple[dict, dict], device):
    """The port's acoustic model and vocoder with the benchmark's weights, as
    ``serving.build_flagship`` builds them: float32 weights in, the vocoder's
    head folded, then cast and put in eval mode."""
    from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams
    from speechflow_torch.models.vocoder import Vocos, VocosParams

    dtype = getattr(torch, cfg["dtype"])
    with torch.device(device):
        am = ParallelTTSModel(ParallelTTSParams.create(dict(cfg["acoustic_model"])))
        vm = Vocos(VocosParams.create(dict(cfg["vocoder"])))
    am.load_state_dict(weights[0])
    vm.load_state_dict(weights[1])
    if not vm.fold_inference(**cfg["fold_inference"]):
        raise RuntimeError("the configuration's vocoder head did not fold")
    return am.to(device, dtype).eval(), vm.to(device, dtype).eval()


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    from speechflow_torch import serving
    from speechflow_torch.models.tts import TTSForwardInput

    cfg, wl = cell.config, cell.workload
    params = wl["traffic"]
    am_cfg, voc_cfg = cfg["acoustic_model"], cfg["vocoder"]
    t_out, hop, sr = params["t_out"], voc_cfg["hop_length"], voc_cfg["sample_rate"]
    core.log("program imported")
    calls = core.traffic(params).make_calls(params, seed, am_cfg)
    weights = make_weights(cfg, seed, device, calls, t_out)
    core.log(f"{len(calls)} calls made, weights drawn")
    am, vm = build_program(cfg, weights, device)
    del weights
    core.log("program built")
    gen = torch.Generator(device=device).manual_seed((seed * 1000003 + 7) % 2 ** 63)
    noises = [torch.randn((c.rows, t_out, am_cfg["n_mels"]), generator=gen, device=device)
              * cfg["cfm_temperature"] for c in calls]
    port_inputs = [TTSForwardInput(**c.inputs) for c in calls]
    acoustic, vocoder = Tap(am.inference, trace), Tap(vm.from_features, trace)
    am.inference, vm.from_features = acoustic, vocoder

    def call(i: int) -> torch.Tensor:
        j = i % len(calls)
        return serving.synthesize(am, vm, port_inputs[j], t_out=t_out, noise=noises[j])

    for i in range(len(calls)):  # every shape the window will use, and the allocator's pools
        call(i)
    torch.cuda.synchronize()
    core.log("every call of the pool run once")
    acoustic.events.clear()
    vocoder.events.clear()
    rng = np.random.default_rng(seed)
    keep = _sample(calls, params, rng)
    kept: tp.Dict[int, dict] = {}
    lengths = []
    torch.cuda.reset_peak_memory_stats()
    setup_s = core.process_age_s()
    t0 = time.perf_counter()
    i = 0
    while True:
        wav = call(i)
        torch.cuda.synchronize()
        te = time.perf_counter()
        out = acoustic.last
        lengths.append(out.spectrogram_lengths)
        if i in keep:
            kept[i] = _outputs(out, wav)
        i += 1
        if te - t0 >= seconds:
            break
    window_s = te - t0
    n_calls = i
    for j in sorted(keep - set(kept)):  # a window too short to reach a sampled call
        wav = call(j)
        out = acoustic.last
        kept[j] = _outputs(out, wav)
    frames = torch.cat(lengths).sum().item()
    audio_s = frames * hop / sr
    core.log(f"window: {n_calls} calls in {window_s:.3f} s, {frames} valid frames of "
             f"{sum(calls[j % len(calls)].rows for j in range(n_calls)) * t_out}")
    res = {"attempted": n_calls, "failed": 0, "setup_s": setup_s,
           "e2e": {"synth_audio_s_per_s": audio_s / window_s},
           "layer": {"config": cfg, "hop": hop}}
    if trace:
        res["layer"]["acoustic_ms"] = acoustic.ms()
        res["layer"]["vocoder_ms"] = vocoder.ms()
        traced = []

        def traced_calls():
            for j in range(params["trace_calls"]):
                call(j)
                torch.cuda.synchronize()
                traced.append((calls[j % len(calls)].lengths,
                               acoustic.last.spectrogram_lengths.tolist()))

        res["layer"]["trace"] = T.profile(torch, traced_calls)
        res["layer"]["traced_calls"] = traced
        core.log(f"traced {params['trace_calls']} calls")
    res["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    am.inference = vm.from_features = None
    del am, vm, acoustic, vocoder, wav, out
    gc.collect()
    torch.cuda.empty_cache()

    weights = make_weights(cfg, seed, device, calls, t_out)
    ref_am, ref_voc = reference_models(cfg, weights, device)
    per_call = [compare.serve_numbers(kept[i], to_device(calls[i % len(calls)].inputs, device),
                                      noises[i % len(calls)], ref_am, ref_voc, t_out, hop)
                for i in sorted(kept)]
    res["numbers"] = compare.merge(per_call)
    core.log(f"reference compared {len(per_call)} calls")
    return res


def _outputs(out, wav: torch.Tensor) -> dict:
    """What the comparison reads of one call of the program."""
    return {"log_d": out.variance_predictions["durations"], "align": out.attention,
            "lengths": out.spectrogram_lengths, "mel": out.spectrogram[-1], "wave": wav}


def _sample(calls: tp.Sequence, params: dict, rng) -> tp.Set[int]:
    """Calls of the window's first pool cycle to judge: the one with the most
    tokens, and ``check_calls`` - 1 more drawn from the seed."""
    n = len(calls)
    longest = max(range(n), key=lambda i: sum(calls[i].lengths))
    others = [int(i) for i in rng.permutation(n) if i != longest]
    return {longest, *others[: params["check_calls"] - 1]}

