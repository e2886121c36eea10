#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                    # build, kernels, slice
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases profile   # where a flagship batch's time goes

Phases, in order (any failure ends the run with a non-zero exit code):

1. ``gpu``: the card's name and power limit, as ``nvidia-smi`` reports them.
2. ``build``: every CUDA kernel of ``speechflow_torch/csrc`` compiled by
   ``nvcc`` for sm_90a from this checkout (one process per source, in
   parallel), with each command, its time and ``ptxas``' register report.
3. ``kernels``: each kernel wrapper on the card at the shapes the flagship
   path gives it, held against its plain PyTorch version on the same inputs
   (f32 and bf16, ragged lengths, T not a multiple of the tile, two tap
   counts), then timed beside its plain version, the library call that
   computes the same function where there is one, and the bound (the least
   time the card could take, from bytes and operations).
4. ``slice``: the flagship serving path (``speechflow_torch.serving``) at
   full width with seeded random weights: request batches at bench shape
   (B=32, 128 tokens, 1024 frames) with launch counts per batch; one small
   f32 batch run through the kernels and through the plain versions.
5. ``profile`` (only when asked for): one flagship batch timed model by
   model, and one under ``torch.profiler``, with device time by kernel
   family and the device's busy share.

The line before the last is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA, or without the
rest of the repository beside this file, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense): HBM bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12}
SR, HOP = 24000, 256
BATCH, T_FRAMES = 32, 1024  # the bench request shape (serving.bench_inputs: 128 tokens)
N_BATCHES = 3  # request batches in the slice; the first is timed apart as warm-up

# flagship per-batch launches (encoder 6 + CFM 30 steps x 6 layers; BigVGAN head:
# 6 stages x 3 MRF branches x 3 activations, first of each branch from the shared
# stage-1 FIR, plus the post activation)
EXPECTED_LAUNCHES = {"fused_attention": 6 + 30 * 6, "anti_alias_snake": 6 * 3 * 2 + 1,
                     "aa_upsample_fir": 6, "aa_snake_downsample": 6 * 3}
HEAD_STAGES = [(4096, 768), (16384, 384), (32768, 192), (65536, 96), (131072, 48),
               (262144, 24)]
KERNEL_META = {
    "fused_attention": ("speechflow_torch/csrc/attention.cu",
                        "speechflow_tpu/ops/attention.py:111"),
    "anti_alias_snake": ("speechflow_torch/csrc/anti_alias.cu",
                         "speechflow_tpu/ops/anti_alias.py:194"),
    "aa_upsample_fir": ("speechflow_torch/csrc/anti_alias.cu",
                        "speechflow_tpu/ops/anti_alias.py:194"),
    "aa_snake_downsample": ("speechflow_torch/csrc/anti_alias.cu",
                            "speechflow_tpu/ops/anti_alias.py:194"),
}


class SmokeError(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeError(what)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, op_type: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1/2 -------------------------------------------------------------------


def phase_gpu() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_build() -> None:
    from speechflow_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build_all()
    for name, r in report.items():
        print(f"[build] {name}: {r['cmd'] or 'cached'}  ({r['seconds']:.1f} s)")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] all kernels built in {time.perf_counter() - t0:.1f} s", flush=True)


# -- phase 3 ---------------------------------------------------------------------


def _attention_cases():
    # (label, B, T, H, dh, lengths): encoder and CFM (CFG-doubled) shapes of the
    # flagship path, plus T not a multiple of the 64-row tile
    yield "encoder", 32, 128, 6, 128, [128] * 31 + [77]
    yield "cfm", 64, 1024, 6, 128, [1024 - 37 * (i % 9) for i in range(64)]
    yield "ragged-T", 4, 1000, 6, 128, [1000, 999, 513, 1]


def check_attention(torch, A) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for label, b, t, h, dh, lens in _attention_cases():
        for dtype, tol in ((torch.float32, 5e-5), (torch.bfloat16, 1.6e-2)):
            q, k, v = (torch.randn(b, t, h, dh, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            valid = torch.arange(t, device="cuda")[None] < torch.tensor(lens, device="cuda")[:, None]
            out = A.fused_attention(q, k, v, valid)
            ref = A.attention_reference(q, k, v, valid)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            print(f"[kernels] fused_attention {label} B{b} T{t} H{h} dh{dh} {dtype}: "
                  f"max_abs_err {err:.3g} (tol {tol:g})", flush=True)
            check(err <= tol, f"fused_attention {label} {dtype}: {err} > {tol}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    return {"max_abs_err": worst}


def time_attention(torch, A) -> dict:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    kinds = {}
    # per flagship batch: 6 encoder launches, 180 CFM launches (bf16 serving)
    for label, b, t, h, dh, lens, calls in (
            ("encoder", 32, 128, 6, 128, [128] * 32, 6),
            ("cfm", 64, 1024, 6, 128, [1024 - 37 * (i % 9) for i in range(64)], 180)):
        q, k, v = (torch.randn(b, t, h, dh, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        lt = torch.tensor(lens, device="cuda")
        valid = torch.arange(t, device="cuda")[None] < lt[:, None]
        ms = cuda_ms(lambda: A.fused_attention(q, k, v, valid), 10)
        plain = cuda_ms(lambda: A.attention_reference(q, k, v, valid), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = valid[:, None, None, :]
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 10)
        nbytes = 4 * b * t * h * dh * q.element_size() + b * t * 4
        ops = 4.0 * h * dh * float((lt.double() ** 2).sum().item())  # valid rows x keys
        bms, kind = bound_ms(nbytes, ops, "bf16")
        kinds[kind] = kinds.get(kind, 0.0) + calls * bms
        print(f"[kernels] fused_attention {label} B{b} T{t} bf16: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.4f} ms ({kind}); "
              f"{calls} launches per batch", flush=True)
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bms)):
            total[key] += calls * val
    total["bound_by"] = max(kinds, key=kinds.get)  # the bound of most of the time
    return total


def check_anti_alias(torch, AA) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"anti_alias_snake": 0.0, "aa_upsample_fir": 0.0, "aa_snake_downsample": 0.0}
    # the six head stages at B=2 (T as on the path), plus T not a multiple of the tile
    shapes = [(2, t, c) for t, c in HEAD_STAGES] + [(3, 1000, 70)]
    for b, t, c in shapes:
        x32 = torch.randn(b, t, c, generator=gen, device="cuda")
        a = 0.3 * torch.randn(c, generator=gen, device="cuda")
        bt = 0.3 * torch.randn(c, generator=gen, device="cuda")
        for taps in (12, 8):
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3.2e-2)):
                x = x32.to(dtype)
                errs = {}
                out = AA.anti_alias_snake(x, a, bt, taps)
                errs["anti_alias_snake"] = out.float() - AA.anti_alias_snake_reference(
                    x, a, bt, taps).float()
                ye, yo = AA.aa_upsample_fir(x, taps)
                pe, po = AA.aa_upsample_fir_reference(x, taps)
                errs["aa_upsample_fir"] = torch.cat([ye.float() - pe.float(),
                                                     yo.float() - po.float()])
                down = AA.aa_snake_downsample(pe, po, a, bt, taps)
                errs["aa_snake_downsample"] = down.float() - AA.aa_snake_downsample_reference(
                    pe, po, a, bt, taps).float()
                torch.cuda.synchronize()
                for name, e in errs.items():
                    err = e.abs().max().item()
                    check(err <= tol, f"{name} B{b} T{t} C{c} taps{taps} {dtype}: {err} > {tol}")
                    if dtype == torch.bfloat16:
                        worst[name] = max(worst[name], err)
                print(f"[kernels] anti-alias B{b} T{t} C{c} taps{taps} {dtype}: max_abs_err "
                      + ", ".join(f"{k} {v.abs().max().item():.3g}" for k, v in errs.items())
                      + f" (tol {tol:g})", flush=True)
    return worst


def time_anti_alias(torch, AA) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4)
    res = {n: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None}
           for n in ("anti_alias_snake", "aa_upsample_fir", "aa_snake_downsample")}
    taps = 12
    for i, (t, c) in enumerate(HEAD_STAGES):
        x = torch.randn(BATCH, t, c, generator=gen, device="cuda", dtype=torch.bfloat16)
        a = 0.3 * torch.randn(c, generator=gen, device="cuda")
        bt = 0.3 * torch.randn(c, generator=gen, device="cuda")
        ye, yo = AA.aa_upsample_fir(x, taps)
        n_el = x.numel()
        es = x.element_size()
        calls = {"anti_alias_snake": 6 + (1 if i == len(HEAD_STAGES) - 1 else 0),
                 "aa_upsample_fir": 1, "aa_snake_downsample": 3}
        runs = {
            "anti_alias_snake": (lambda: AA.anti_alias_snake(x, a, bt, taps),
                                 lambda: AA.anti_alias_snake_reference(x, a, bt, taps),
                                 2 * n_el * es, (4 * taps + 10) * n_el),
            "aa_upsample_fir": (lambda: AA.aa_upsample_fir(x, taps),
                                lambda: AA.aa_upsample_fir_reference(x, taps),
                                3 * n_el * es, 2 * taps * n_el),
            "aa_snake_downsample": (lambda: AA.aa_snake_downsample(ye, yo, a, bt, taps),
                                    lambda: AA.aa_snake_downsample_reference(ye, yo, a, bt, taps),
                                    3 * n_el * es, (2 * taps + 10) * n_el),
        }
        for name, (kern, plain, nbytes, ops) in runs.items():
            ms = cuda_ms(kern, 5)
            pms = cuda_ms(plain, 2, warmup=1)
            bms, kind = bound_ms(nbytes, ops, "f32")  # arithmetic is f32 for both dtypes
            res[name]["ms"] += calls[name] * ms
            res[name]["plain_ms"] += calls[name] * pms
            res[name]["bound_ms"] += calls[name] * bms
            res[name]["bound_by"] = kind
            print(f"[kernels] {name} B{BATCH} T{t} C{c} bf16 taps{taps}: kernel {ms:.4f} ms, "
                  f"plain {pms:.4f} ms, bound {bms:.4f} ms ({kind}); "
                  f"{calls[name]} launches per batch", flush=True)
        del x, ye, yo
        torch.cuda.empty_cache()
    return res


def phase_kernels(torch) -> dict:
    from speechflow_torch.ops import anti_alias as AA
    from speechflow_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = {"fused_attention": check_attention(torch, A)}
    records["fused_attention"].update(time_attention(torch, A))
    for name, err in check_anti_alias(torch, AA).items():
        records[name] = {"max_abs_err": err}
    for name, r in time_anti_alias(torch, AA).items():
        records[name].update(r)
    return records


# -- phase 4 ---------------------------------------------------------------------


def _counters():
    from speechflow_torch.ops import anti_alias as AA
    from speechflow_torch.ops import attention as A

    return {"fused_attention": A.fused_attention, "anti_alias_snake": AA.anti_alias_snake,
            "aa_upsample_fir": AA.aa_upsample_fir,
            "aa_snake_downsample": AA.aa_snake_downsample}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain versions (on the card)."""
    from speechflow_torch.models.vocoder import heads
    from speechflow_torch.ops import anti_alias as AA
    from speechflow_torch.ops import attention as A

    saved = [(A, "fused_attention", A.fused_attention),
             (heads, "anti_alias_snake", heads.anti_alias_snake),
             (heads, "aa_upsample_fir", heads.aa_upsample_fir),
             (heads, "aa_snake_downsample", heads.aa_snake_downsample)]
    A.fused_attention = A.attention_reference
    heads.anti_alias_snake = AA.anti_alias_snake_reference
    heads.aa_upsample_fir = AA.aa_upsample_fir_reference
    heads.aa_snake_downsample = AA.aa_snake_downsample_reference
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_slice(torch, gpu_line: str) -> dict:
    import numpy as np

    from speechflow_torch import serving

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    am, vm = serving.build_flagship("default", device="cuda", dtype=torch.bfloat16, seed=0)
    print(f"[slice] flagship built (bf16, seeded random weights) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    n_samples = (T_FRAMES - 1) * HOP
    gen = torch.Generator(device="cuda").manual_seed(0)

    reset_counts()
    times = []
    for i in range(N_BATCHES):
        inputs = serving.bench_inputs(rng, batch=BATCH)
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = serving.synthesize(am, vm, inputs, t_out=T_FRAMES, generator=gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = read_counts()
        per_batch = {k: after[k] - before[k] for k in after}
        check(tuple(wav.shape) == (BATCH, n_samples),
              f"waveform shape {tuple(wav.shape)} != {(BATCH, n_samples)}")
        w = wav.float()
        check(bool(torch.isfinite(w).all()), "non-finite waveform")
        std = w.std(dim=-1).min().item()
        check(std > 1e-4, f"silent waveform (min per-utterance std {std:.3g})")
        check(per_batch == EXPECTED_LAUNCHES,
              f"launches per batch {per_batch} != {EXPECTED_LAUNCHES}")
        print(f"[slice] batch {i}: {dt * 1e3:.1f} ms, wave {tuple(wav.shape)}, "
              f"min std {std:.4f}, launches {per_batch}", flush=True)
        if i > 0:  # the first batch also selects cuDNN algorithms and fills caches
            times.append(dt)
    launches = read_counts()
    ms = 1e3 * sum(times) / len(times)
    xrt = BATCH * n_samples / SR / (ms / 1e3)
    print(f"[slice] end to end: {ms:.1f} ms per batch of {BATCH} x {n_samples / SR:.2f} s "
          f"= {xrt:.1f}x realtime (bf16, batches after the first, {gpu_line})", flush=True)
    del am, vm, wav
    torch.cuda.empty_cache()

    # one small f32 batch through the kernels and through the plain versions
    am, vm = serving.build_flagship("default", device="cuda", dtype=torch.float32, seed=0)
    inputs = serving.bench_inputs(np.random.default_rng(1), batch=2)
    noise = torch.randn(am.noise_shape(inputs, T_FRAMES), generator=gen,
                        device="cuda") * am.decoder.temperature
    outs = []
    for ctx in (contextlib.nullcontext(), plain_versions()):
        with ctx, torch.inference_mode():
            x = inputs.to("cuda", torch.float32)
            out = am(x, t_out=T_FRAMES, noise=noise)
            mel = out.spectrogram[-1]
            outs.append((out.attention.sum(1), out.spectrogram_lengths, mel,
                         vm.from_features(mel)))
    (d_k, len_k, mel_k, wav_k), (d_p, _, mel_p, wav_p) = outs
    check(torch.equal(d_k, d_p), "predicted durations differ between kernels and plain")
    valid = (torch.arange(T_FRAMES, device="cuda")[None] < len_k[:, None])[..., None]
    mel_err = ((mel_k - mel_p).abs() * valid).max().item()
    wav_err = (wav_k - wav_p).abs().max().item()
    print(f"[slice] f32 B2 kernels vs plain: durations equal ({int(d_k.sum())} frames), "
          f"mel max_abs_err {mel_err:.3g} (tol 2e-3), wave max_abs_err {wav_err:.3g} "
          f"(tol 2e-3)", flush=True)
    check(mel_err <= 2e-3 and wav_err <= 2e-3, "f32 slice: kernels disagree with plain")
    return {"launches": launches, "ms_per_batch": ms, "xrt": xrt}


# -- profile (opt-in) ----------------------------------------------------------------

# device kernels by family, matched on the kernel's name, first match wins
FAMILIES = (("fused_attention", ("attn_fwd",)), ("anti_alias", ("aa_kernel",)),
            ("convolution", ("conv", "cudnn", "implicit", "winograd", "fft")),
            ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "wgmma", "nvjet")),
            ("elementwise and norms", ("elementwise", "layer_norm", "catarray", "reduce")))


# rows of the profile that are host operators or runtime calls, not device work: they
# repeat the device time of the kernels they launch and would count it twice
HOST_ROWS = ("aten::", "cuda", "cuLaunch")


def _self_device_us(event) -> float:
    dev = getattr(event, "self_device_time_total", None)  # older torch: self_cuda_time_total
    return event.self_cuda_time_total if dev is None else dev


def _family(name: str) -> str:
    low = name.lower()
    return next((fam for fam, keys in FAMILIES if any(k in low for k in keys)), "other")


def phase_profile(torch, gpu_line: str) -> None:
    """One flagship batch split into its two models (host clock around each,
    synchronised), then one batch under ``torch.profiler``: device time by
    kernel family, the device's busy share and the slowest convolutions by
    shape. The full per-kernel table goes to ``chiprun_out/profile_slice.txt``, the
    run's git-ignored output directory."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speechflow_torch import serving

    am, vm = serving.build_flagship("default", device="cuda", dtype=torch.bfloat16, seed=0)
    inputs = serving.bench_inputs(np.random.default_rng(2), batch=BATCH)
    gen = torch.Generator(device="cuda").manual_seed(2)
    serving.synthesize(am, vm, inputs, t_out=T_FRAMES, generator=gen)  # warm-up
    with torch.inference_mode():
        x = inputs.to("cuda", torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel = am(x, t_out=T_FRAMES, generator=gen).spectrogram[-1]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vm.from_features(mel)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    print(f"[profile] acoustic model {1e3 * (t1 - t0):.1f} ms, vocoder {1e3 * (t2 - t1):.1f} ms "
          f"per batch of {BATCH} (bf16, {gpu_line})", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        serving.synthesize(am, vm, inputs, t_out=T_FRAMES, generator=gen)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows, queue_full = [], None
    for e in prof.key_averages():
        dev = _self_device_us(e)
        if e.key == "Command Buffer Full":  # the host waiting on a full launch queue
            queue_full = (e.count, dev)
        elif (e.device_type == DeviceType.CUDA and dev > 0
              and not e.key.startswith(HOST_ROWS)):
            rows.append((dev, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    check(busy > 0, "the profiler recorded no device time")
    if queue_full:
        print(f"[profile] launch queue full {queue_full[0]} times, "
              f"{queue_full[1] / 1e3:.1f} ms in all", flush=True)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "profile_slice.txt", "w") as f:
        f.write(f"# one flagship batch (B={BATCH}, bf16), {gpu_line}; wall {wall_us:.0f} us\n")
        f.write("# self device us, calls, share, family, name\n")
        for dev, count, key in rows:
            f.write(f"{dev:.0f}\t{count}\t{dev / busy:.4f}\t{_family(key)}\t{key}\n")
    by_family = {}
    for dev, _, key in rows:
        by_family[_family(key)] = by_family.get(_family(key), 0.0) + dev
    print(f"[profile] device busy {busy / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall "
          f"({busy / wall_us:.3f} busy share, the profiler on)", flush=True)
    for fam, dev in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {fam}: {dev / 1e3:.1f} ms ({dev / busy:.3f} of device time)")
    for dev, count, key in rows[:12]:
        print(f"[profile]   {dev / 1e3:9.2f} ms {count:6d}x  {key[:90]}")
    # which layers the convolution time belongs to: (input, weight) shapes, slowest first
    convs = sorted(((_self_device_us(e), e.count, e.input_shapes[:2])
                    for e in prof.key_averages(group_by_input_shape=True)
                    if e.key == "aten::cudnn_convolution"), reverse=True)
    for dev, count, shapes in convs[:8]:
        print(f"[profile]   conv {dev / 1e3:9.2f} ms {count:4d}x  input, weight {shapes}")


# -- main --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="build,kernels,slice",
                    help="comma-separated subset of build,kernels,slice,profile "
                         "(profile is not in the default run)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU", file=sys.stderr)
        return 2
    if not (REPO / "speechflow_torch" / "csrc").is_dir():
        print(f"chip_smoke: no speechflow_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    gpu_line = phase_gpu()
    records = {}
    phase_build()
    if "kernels" in phases:
        records = phase_kernels(torch)
    if "slice" in phases:
        slice_res = phase_slice(torch, gpu_line)
        check(all(v > 0 for v in slice_res["launches"].values()),
              f"a kernel of the path was never launched: {slice_res['launches']}")
        for name, n in slice_res["launches"].items():
            records.setdefault(name, {})["launches"] = n
    if "profile" in phases:
        phase_profile(torch, gpu_line)

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = records.get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": r.get("launches"), "max_abs_err": r.get("max_abs_err"),
                        "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                        "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
                        "library_ms": r.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(gpu_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
