"""Times the folded conv's formulations on one GPU, at the flagship head's
folded width (B32, 16384 steps, 384 wide, bf16), for K' from 3 to 27 taps:

- ``ops.folded.folded_conv``, as shipped: a channels-last conv2d, split into
  balanced chunks of at most ``MAX_TAPS_PER_CONV`` taps;
- K' shifted batched products accumulated into one output;
- above ``MAX_TAPS_PER_CONV``, one unchunked conv2d.

Each with its TFLOP/s and its error against the f32 ``folded_conv`` on two
rows of the batch. This is the measurement behind ``MAX_TAPS_PER_CONV``.

    python3 -m speechflow_torch.tools.folded_conv_sweep
"""

from __future__ import annotations

import subprocess

import torch
import torch.nn.functional as F

from speechflow_torch.ops import folded as fd

B, S, W = 32, 1024 * 16, 384  # stages 3-6 of the flagship head, folded
TAPS = (3, 5, 7, 9, 11, 15, 17, 19, 27)


def shifted_products(xf, w_f, pad, bias_f):
    """A folded conv as K' batched products on shifted views, accumulated."""
    b, s, _ = xf.shape
    xp = F.pad(xf, (0, 0, pad[0], pad[1]))
    out = torch.baddbmm(bias_f.expand(b, s, -1), xp[:, :s], w_f[0].expand(b, -1, -1))
    for k in range(1, w_f.shape[0]):
        out.baddbmm_(xp[:, k:k + s], w_f[k].expand(b, -1, -1))
    return out


def one_conv2d(xf, w_f, pad, bias_f):
    """A folded conv as one channels-last conv2d, however many taps."""
    x4 = F.pad(xf, (0, 0, pad[0], pad[1])).permute(0, 2, 1).unsqueeze(2)
    w4 = w_f.permute(2, 1, 0).unsqueeze(2).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x4, w4, bias_f).squeeze(2).permute(0, 2, 1)


def cuda_ms(fn, iters: int = 3, warmup: int = 1) -> float:
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("folded_conv_sweep: CUDA is not available; this script runs on a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(B, S, W, generator=gen, device="cuda", dtype=torch.bfloat16)
    forms = {"folded_conv": fd.folded_conv, "shifted products": shifted_products,
             "one conv2d": one_conv2d}
    for kp in TAPS:
        wf = (torch.randn(kp, W, W, generator=gen, device="cuda") / (kp * W) ** 0.5).bfloat16()
        bias = torch.randn(W, generator=gen, device="cuda", dtype=torch.bfloat16)
        pad = (kp // 2, kp - 1 - kp // 2)
        ref = fd.folded_conv(x[:2].float(), wf.float(), pad, bias.float())
        names = ["folded_conv", "shifted products"]
        if kp > fd.MAX_TAPS_PER_CONV:
            names.append("one conv2d")
        row = []
        for name in names:
            ms = cuda_ms(lambda: forms[name](x, wf, pad, bias))
            err = (forms[name](x[:2], wf, pad, bias).float() - ref).abs().max().item()
            row.append(f"{name} {ms:.3f} ms ({2.0 * B * S * W * W * kp / ms / 1e9:.0f} TFLOP/s,"
                       f" max_abs_err vs f32 {err:.3g})")
        print(f"[folded_conv] K'={kp} B{B} S{S} W{W} bf16: " + "; ".join(row), flush=True)
    print(f"[folded_conv] ({card})", flush=True)


if __name__ == "__main__":
    main()
