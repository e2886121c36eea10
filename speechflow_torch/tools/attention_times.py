"""Times ``ops.attention.fused_attention`` on one GPU at the shapes the serving
paths give it, beside its plain version, SDPA (one PyTorch call that computes
the same function) and its bound, each row with its launches a batch or
request:

- the flagship and toy programs (bf16, the ``wgmma`` kernel);
- the f32 TTS interface at 32 sentences and the bundle's one sentence (the
  f32 default of the serving entry points: the TF32 kernel at dh 128);
- the XTTS prompt encoder (f32, dh 256), serving and training (B32);
- the prosody model (f32, 4 heads of 64): a sentence at inference (one row,
  T = words rounded up to 16), and a training step of the default preset
  (B64, 64 word slots).

It uses nothing but the wrapper's public functions, so the same file run from
an older checkout times that checkout's kernel: to compare two trees, run it
from each in one call on one card, in turns (old, new, new, old).

    python3 -m speechflow_torch.tools.attention_times [--rows f32]

Bound: the larger of the bytes (q, k, v, out and the validity, once each)
over 3.35 TB/s and the operations (4 dh flops for each valid row x valid key
pair) over the peak of their type: 989 TFLOP/s for bf16; for f32, three TF32
products at 495 TFLOP/s (f32 accuracy on the tensor cores, which the f32
kernel takes), beside the old figure of one product at the 67 TFLOP/s of the
CUDA cores.
"""

from __future__ import annotations

import argparse
import subprocess
import typing as tp

import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet; dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
TF32_PRODUCTS = 3  # an f32 product at f32 accuracy on the tensor cores: 3xTF32


def _cfm_lengths(b: int) -> tp.List[int]:
    return [1024 - 37 * (i % 9) for i in range(b)]


def _ragged(b: int, t: int, step: int) -> tp.List[int]:
    return [max(1, t - step * (i % 16)) for i in range(b)]


# (program, label, B, T, H, dh, lengths, launches a batch, request, sentence or training
# step, type). The bundle's sentence is ``chip_smoke.BUNDLE_SENTENCE``: 58 tokens (char
# fallback), 297 frames at the seeded flagship's durations (75776 samples), doubled by
# CFG; the f32 TTS interface row takes the flagship's bench shape, as its bf16 serving
# path does. A prosody sentence of 10 words is one 16-token row; a prosody training batch
# has 64 rows of 64 word slots (``ProsodySampleLoader``), 10..40 words valid here. The
# aligner aligns 16 SEGS utterances a batch (their stage-1 token counts, padded to 16);
# the E2E generator serves 4 SEGS test utterances, its decoder over the recipe's
# max_output_length of 4096 frames with 4 frames a token valid.
ROWS = (
    ("flagship", "encoder", 32, 128, 6, 128, [128] * 32, 6, "bf16"),
    ("flagship", "cfm", 64, 1024, 6, 128, _cfm_lengths(64), 180, "bf16"),
    ("toy", "encoder", 32, 128, 4, 64, [128] * 32, 4, "bf16"),
    ("toy", "cfm", 32, 1024, 4, 64, _cfm_lengths(32), 120, "bf16"),
    ("tts_f32", "encoder", 32, 128, 6, 128, [128] * 32, 6, "f32"),
    ("tts_f32", "cfm", 64, 1024, 6, 128, _cfm_lengths(64), 180, "f32"),
    ("bundle", "encoder", 1, 58, 6, 128, [58], 6, "f32"),
    ("bundle", "cfm", 2, 1024, 6, 128, [297, 297], 180, "f32"),
    ("xtts", "prompt", 1, 112, 4, 256, [112], 4, "f32"),
    ("xtts_train", "prompt", 32, 112, 4, 256, _ragged(32, 112, 3), 4, "f32"),
    ("prosody", "sentence", 1, 16, 4, 64, [10], 4, "f32"),
    ("prosody_train", "step", 64, 64, 4, 64, _ragged(64, 40, 2), 4, "f32"),
    ("aligner", "align", 16, 144, 2, 96,
     [138, 132, 75, 129, 69, 23, 101, 105, 91, 30, 18, 88, 47, 65, 88, 78], 4, "f32"),
    ("e2e", "encoder", 4, 96, 4, 64, [66, 58, 87, 76], 4, "f32"),
    ("e2e", "decoder", 4, 4096, 4, 64, [264, 232, 348, 304], 4, "f32"),
)
TYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms a call over ``iters`` back-to-back calls, by CUDA events."""
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


def bound_ms(b: int, t: int, h: int, dh: int, lens: tp.Sequence[int], dtype) -> tp.Tuple:
    """(ms, kind) of the least time the card could take for one call, and the f32
    figure at the CUDA cores' rate (None for bf16)."""
    es = torch.finfo(dtype).bits // 8
    t_bytes = (4 * b * t * h * dh * es + b * t) / HBM_BYTES_PER_S * 1e3
    ops = 4.0 * h * dh * sum(n * n for n in lens)  # valid rows x valid keys
    if dtype == torch.bfloat16:
        t_ops, cuda_cores = ops / PEAK_OPS["bf16"] * 1e3, None
    else:
        t_ops = TF32_PRODUCTS * ops / PEAK_OPS["tf32"] * 1e3
        cuda_cores = max(t_bytes, ops / PEAK_OPS["f32"] * 1e3)
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) + (cuda_cores,)


def inputs(b: int, t: int, h: int, dh: int, lens, dtype, gen: torch.Generator):
    q, k, v = (torch.randn(b, t, h, dh, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    valid = torch.arange(t, device="cuda")[None] < torch.tensor(lens, device="cuda")[:, None]
    return q, k, v, valid


def times(A, q, k, v, valid, iters: int = 10) -> tp.Dict[str, float]:
    """ms a call of the kernel, of the plain version and of SDPA on the same inputs."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = valid[:, None, None, :]
    return {"ms": cuda_ms(lambda: A.fused_attention(q, k, v, valid), iters),
            "plain_ms": cuda_ms(lambda: A.attention_reference(q, k, v, valid), max(2, iters // 2)),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), iters)}


def main(argv=None) -> int:
    from speechflow_torch.ops import attention as A

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", choices=("all", "f32"), default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_times: needs an NVIDIA GPU")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(2)
    for program, label, b, t, h, dh, lens, calls, type_name in ROWS:
        if args.rows == "f32" and type_name != "f32":
            continue
        dtype = TYPES[type_name]
        q, k, v, valid = inputs(b, t, h, dh, lens, dtype, gen)
        r = times(A, q, k, v, valid)
        bms, kind, cores = bound_ms(b, t, h, dh, lens, dtype)
        err = (A.fused_attention(q, k, v, valid).float()
               - A.attention_reference(q, k, v, valid).float()).abs().max().item()
        extra = f", CUDA-core bound {cores:.5f} ms" if cores is not None else ""
        print(f"{program} {label} B{b} T{t} H{h} dh{dh} {type_name}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound {bms:.5f} ms "
              f"({kind}{extra}), {bms / r['ms']:.3f} of it; {calls} launches a batch: "
              f"{calls * r['ms']:.2f} ms; max_abs_err {err:.3g}", flush=True)
        del q, k, v, valid
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
