"""Anti-aliased snake activation (counterpart of ``speechflow_tpu/ops/anti_alias.py``).

2x upsample + Kaiser-sinc FIR -> snake-beta -> the same FIR + 2x decimation,
in polyphase form at input rate. Three entries, each the wrapper of one
launch of the hand-written CUDA kernel ``csrc/anti_alias.cu`` (which replaces
the TPU kernel ``anti_alias_snake_pallas``):

- ``anti_alias_snake``: all stages fused; the 2x intermediate never reaches
  device memory;
- ``aa_upsample_fir``: stage 1 only, as (even, odd) phase signals — an MRF
  group computes it once and shares it across its branches;
- ``aa_snake_downsample``: the snake and stage 2 on such a pair.

On CPU tensors each runs its plain PyTorch version (``*_reference``), the
shifted-add composition of ``anti_alias_snake_xla``. The plain versions and
the kernel compute in f32 (the plain versions in float64 for float64 inputs)
and return the input's dtype. Derivation (taps K,
XLA SAME anchoring pad_left p = (K-1)//2):

  stage 1: y_even[i] = sum_{k-p even} 2 f[k] x[i + (k-p)/2]
           y_odd[i]  = sum_{k-p odd}  2 f[k] x[i + (k-p+1)/2]
  stage 2: out[i] = sum_{k-p even} f[k] z_even[i + (k-p)/2]
                  + sum_{k-p odd}  f[k] z_odd[i + (k-p-1)/2],  z = snake(y)

Gradients. On the GPU each entry is a ``torch.autograd.Function``: the
forward is the kernel launch, the backward the VJP (``*_vjp``), which on CUDA
tensors is a hand-written kernel of the same source (the JAX package's custom
VJP differentiates the XLA composition in its backward,
``_make_anti_alias_snake``). Each Function saves its inputs only (the fused
entry its input as the kernel read it, contiguous); the fused VJP kernel
recomputes stage 1 in f32 registers. Every FIR is a sum of shifted
copies with zeros outside [0, T), so its transpose is the same sum with the
shifts negated; the edge rules follow. The VJP kernels compute in f32 and write
each gradient in its input's dtype (dx in x's, dy in y's, dα and dβ in α's and
β's); dα and dβ are each (batch, run)'s partial sums reduced by a second
kernel in a fixed order, so two calls give the same bits. Their launches are
counted in ``<vjp>.launches``. On CUDA tensors the VJPs always launch the
kernels: float64 activations are refused, as by the forward, and α and β of
another dtype reach the kernels as f32 copies, their gradients cast back. On
CPU tensors the VJPs run their plain versions in torch ops (``*_vjp_reference``:
f32, float64 for float64 inputs), which the GPU tests hold the kernels against;
the entries' plain versions on CPU tensors run under PyTorch's own autograd.
"""

from __future__ import annotations

import ctypes
import functools
import math
import typing as tp

import numpy as np
import torch

from speechflow_torch.ops import _build
from speechflow_torch.utils.profiler import span

__all__ = ["kaiser_sinc_filter", "anti_alias_snake", "aa_upsample_fir",
           "aa_snake_downsample", "anti_alias_snake_reference",
           "aa_upsample_fir_reference", "aa_snake_downsample_reference",
           "anti_alias_snake_vjp", "aa_upsample_fir_vjp", "aa_snake_downsample_vjp",
           "anti_alias_snake_vjp_reference", "aa_upsample_fir_vjp_reference",
           "aa_snake_downsample_vjp_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TAPS = 16


@functools.lru_cache(maxsize=None)
def kaiser_sinc_filter(cutoff: float = 0.25, half_width: float = 0.15,
                       taps: int = 12) -> np.ndarray:
    """Kaiser-windowed sinc low-pass, the same design as the JAX package's."""
    even = taps % 2 == 0
    half = taps // 2
    delta_f = 4 * half_width
    a = 2.285 * (half - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    t = np.arange(-half, half) + 0.5 if even else np.arange(taps) - half
    window = np.kaiser(taps, beta)
    ideal = 2 * cutoff * np.sinc(2 * cutoff * t)
    filt = ideal * window
    return (filt / filt.sum()).astype(np.float32)


# -- plain versions -------------------------------------------------------------


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or in float64 where it is float64 (the plain versions'
    compute type: the kernels' f32, never narrower than the input)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _shifter(v: torch.Tensor, m: int):
    t = v.shape[1]
    vp = torch.nn.functional.pad(v, (0, 0, m, m))
    return lambda s: vp[:, m + s: m + s + t]


def _snake(y: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    a = torch.exp(_wide(alpha))
    inv_b = 1.0 / (torch.exp(_wide(beta)) + 1e-9)
    return y + inv_b * torch.sin(a * y) ** 2


def _phases_f32(x: torch.Tensor, taps: int) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    filt = kaiser_sinc_filter(taps=taps)
    p = (taps - 1) // 2
    sh = _shifter(_wide(x), taps // 2 + 1)
    y_even = y_odd = None
    for k in range(taps):
        w = 2.0 * float(filt[k])
        if (k - p) % 2 == 0:
            part = w * sh((k - p) // 2)
            y_even = part if y_even is None else y_even + part
        else:
            part = w * sh((k - p + 1) // 2)
            y_odd = part if y_odd is None else y_odd + part
    return y_even, y_odd


def _downsample_f32(y_even, y_odd, alpha, beta, taps: int) -> torch.Tensor:
    filt = kaiser_sinc_filter(taps=taps)
    p = (taps - 1) // 2
    m = taps // 2 + 1
    sh_e = _shifter(_snake(_wide(y_even), alpha, beta), m)
    sh_o = _shifter(_snake(_wide(y_odd), alpha, beta), m)
    out = None
    for k in range(taps):
        w = float(filt[k])
        part = w * (sh_e((k - p) // 2) if (k - p) % 2 == 0 else sh_o((k - p - 1) // 2))
        out = part if out is None else out + part
    return out


def aa_upsample_fir_reference(x: torch.Tensor, taps: int = 12
                              ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    y_even, y_odd = _phases_f32(x, taps)
    return y_even.to(x.dtype), y_odd.to(x.dtype)


def aa_snake_downsample_reference(y_even: torch.Tensor, y_odd: torch.Tensor,
                                  alpha: torch.Tensor, beta: torch.Tensor,
                                  taps: int = 12) -> torch.Tensor:
    return _downsample_f32(y_even, y_odd, alpha, beta, taps).to(y_even.dtype)


def anti_alias_snake_reference(x: torch.Tensor, alpha: torch.Tensor,
                               beta: torch.Tensor, taps: int = 12) -> torch.Tensor:
    y_even, y_odd = _phases_f32(x, taps)
    return _downsample_f32(y_even, y_odd, alpha, beta, taps).to(x.dtype)


# -- kernel wrappers ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)  # cached: a normal tensor even when first built in inference
def _filter_on(taps: int, device: str) -> torch.Tensor:
    return torch.as_tensor(kaiser_sinc_filter(taps=taps), device=device)


def _check(name: str, taps: int, *xs: torch.Tensor) -> None:
    if not 1 <= taps <= MAX_TAPS:
        raise ValueError(f"{name}: taps must be in [1, {MAX_TAPS}], got {taps}")
    x0 = xs[0]
    if x0.ndim != 3:
        raise ValueError(f"{name}: expected (B, T, C), got {tuple(x0.shape)}")
    for x in xs:
        if x.shape != x0.shape or x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError(f"{name}: inputs differ in shape, dtype or device")
    if x0.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x0.dtype}")
    if x0.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x0.device}")


def _params(alpha: torch.Tensor, beta: torch.Tensor, c: int, device) -> tuple:
    a = alpha.to(device=device, dtype=torch.float32).contiguous()
    b = beta.to(device=device, dtype=torch.float32).contiguous()
    if a.shape != (c,) or b.shape != (c,):
        raise ValueError(f"alpha/beta must be ({c},), got {tuple(a.shape)}/{tuple(b.shape)}")
    return a, b


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


_P5 = [ctypes.c_void_p] * 5
_I5 = [ctypes.c_int] * 5


def _launch_fused(x, alpha, beta, taps: int) -> torch.Tensor:
    _check("anti_alias_snake", taps, x)
    b, t, c = x.shape
    x = x.contiguous()
    a, bt = _params(alpha, beta, c, x.device)
    out = torch.empty_like(x)
    fn = _build.function("anti_alias", "sf_aa_snake_fused", _P5 + _I5 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), a.data_ptr(), bt.data_ptr(),
             _filter_on(taps, str(x.device)).data_ptr(), out.data_ptr(),
             b, t, c, taps, _DTYPES[x.dtype], _stream(x))
    _build.check(err, "sf_aa_snake_fused")
    anti_alias_snake.launches += 1
    return out


def _launch_upsample(x, taps: int) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    _check("aa_upsample_fir", taps, x)
    b, t, c = x.shape
    x = x.contiguous()
    y_even, y_odd = torch.empty_like(x), torch.empty_like(x)
    fn = _build.function("anti_alias", "sf_aa_upsample_fir",
                         [ctypes.c_void_p] * 4 + _I5 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), _filter_on(taps, str(x.device)).data_ptr(),
             y_even.data_ptr(), y_odd.data_ptr(), b, t, c, taps, _DTYPES[x.dtype],
             _stream(x))
    _build.check(err, "sf_aa_upsample_fir")
    aa_upsample_fir.launches += 1
    return y_even, y_odd


def _launch_downsample(y_even, y_odd, alpha, beta, taps: int) -> torch.Tensor:
    _check("aa_snake_downsample", taps, y_even, y_odd)
    b, t, c = y_even.shape
    y_even, y_odd = y_even.contiguous(), y_odd.contiguous()
    a, bt = _params(alpha, beta, c, y_even.device)
    out = torch.empty_like(y_even)
    fn = _build.function("anti_alias", "sf_aa_snake_downsample",
                         [ctypes.c_void_p] * 6 + _I5 + [ctypes.c_void_p])
    err = fn(y_even.data_ptr(), y_odd.data_ptr(), a.data_ptr(), bt.data_ptr(),
             _filter_on(taps, str(y_even.device)).data_ptr(), out.data_ptr(),
             b, t, c, taps, _DTYPES[y_even.dtype], _stream(y_even))
    _build.check(err, "sf_aa_snake_downsample")
    aa_snake_downsample.launches += 1
    return out


# -- the VJPs: plain versions (torch ops) ----------------------------------------


@functools.lru_cache(maxsize=None)
def _fir_terms(taps: int) -> tp.Dict[str, tp.Tuple[tp.Tuple[float, int], ...]]:
    """(weight, shift) of every term of the four polyphase FIRs:
    ``out[i] = sum w * v[i + shift]``, v zero outside [0, T)."""
    filt = kaiser_sinc_filter(taps=taps)
    p = (taps - 1) // 2
    even = [k for k in range(taps) if (k - p) % 2 == 0]
    odd = [k for k in range(taps) if (k - p) % 2 != 0]
    return {"up_even": tuple((2.0 * float(filt[k]), (k - p) // 2) for k in even),
            "up_odd": tuple((2.0 * float(filt[k]), (k - p + 1) // 2) for k in odd),
            "down_even": tuple((float(filt[k]), (k - p) // 2) for k in even),
            "down_odd": tuple((float(filt[k]), (k - p - 1) // 2) for k in odd)}


def _fir_transposed(g: torch.Tensor, terms, out: tp.Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The transpose of ``out[i] = sum w * v[i + s]`` applied to ``g`` (B, T, C):
    ``dv[j] = sum w * g[j - s]``, zeros outside [0, T); added into ``out``."""
    t = g.shape[1]
    out = torch.zeros_like(g) if out is None else out
    for w, s in terms:
        lo, hi = max(0, s), min(t, t + s)  # j with 0 <= j - s < T
        if lo < hi:
            out[:, lo:hi].add_(g[:, lo - s:hi - s], alpha=w)
    return out


def _snake_vjp(y: torch.Tensor, dz: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor
               ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Through z = y + sin²(a·y)/(e^β + 1e-9), a = e^α (f32): dy, and the
    (C,) sums over (B, T) of dα and dβ."""
    a = torch.exp(_wide(alpha))
    e_b = torch.exp(_wide(beta))
    inv_b = 1.0 / (e_b + 1e-9)
    s2 = torch.sin(2.0 * a * y)
    dy = dz * (1.0 + a * inv_b * s2)
    d_alpha = (dz * y * s2).sum((0, 1)) * (a * inv_b)
    d_beta = (dz * torch.sin(a * y) ** 2).sum((0, 1)) * (-e_b * inv_b * inv_b)
    return dy, d_alpha, d_beta


@torch.no_grad()
def aa_upsample_fir_vjp_reference(g_even: tp.Optional[torch.Tensor],
                                  g_odd: tp.Optional[torch.Tensor], taps: int = 12
                                  ) -> torch.Tensor:
    """dx of stage 1 from the cotangents of its (even, odd) outputs (either may
    be None, i.e. zero), in f32."""
    terms = _fir_terms(taps)
    dx = None
    for g, key in ((g_even, "up_even"), (g_odd, "up_odd")):
        if g is not None:
            dx = _fir_transposed(_wide(g), terms[key], dx)
    return dx


@torch.no_grad()
def aa_snake_downsample_vjp_reference(y_even: torch.Tensor, y_odd: torch.Tensor,
                                      alpha: torch.Tensor, beta: torch.Tensor,
                                      g: torch.Tensor, taps: int = 12
                                      ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                    torch.Tensor]:
    """(dy_even, dy_odd, dα, dβ) of the snake and stage 2, each in its input's dtype."""
    terms = _fir_terms(taps)
    g = _wide(g)
    dy_e, da_e, db_e = _snake_vjp(_wide(y_even), _fir_transposed(g, terms["down_even"]),
                                  alpha, beta)
    dy_o, da_o, db_o = _snake_vjp(_wide(y_odd), _fir_transposed(g, terms["down_odd"]),
                                  alpha, beta)
    return (dy_e.to(y_even.dtype), dy_o.to(y_odd.dtype), (da_e + da_o).to(alpha.dtype),
            (db_e + db_o).to(beta.dtype))


@torch.no_grad()
def anti_alias_snake_vjp_reference(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                                   g: torch.Tensor, taps: int = 12
                                   ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dα, dβ) of the fused entry: stage 1 recomputed in f32 by its plain
    version, then the two plain VJPs above."""
    y_even, y_odd = aa_upsample_fir_reference(x.float(), taps)
    dy_e, dy_o, d_alpha, d_beta = aa_snake_downsample_vjp_reference(y_even, y_odd, alpha,
                                                                    beta, g, taps)
    return aa_upsample_fir_vjp_reference(dy_e, dy_o, taps).to(x.dtype), d_alpha, d_beta


# -- the VJPs: kernel wrappers ----------------------------------------------------

# A VJP thread walks a run of rows and recomputes or rereads a halo of 5-8 rows at each
# end, so the snake's VJPs waste least with long runs (64 rows); stage 1's transpose has no
# snake to recompute and runs fastest with short ones (16), as its forward does (measured on
# the H100, PERF.md). A run is halved, down to one chunk of 8 rows, while it is twice T or
# the launch would give the card's SMs fewer than 256 threads each.
@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _vjp_run_len(b: int, t: int, c: int, sms: int, longest: int = 64) -> int:
    run = longest
    while run > 8 and (run // 2 >= t or b * -(-t // run) * -(-c // 2) < 256 * sms):
        run //= 2
    return run


def _param_grads(alpha: torch.Tensor, beta: torch.Tensor, b: int, t: int, c: int, run: int,
                 device) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, tuple]:
    """The buffers the kernels write dα and dβ to (in α's and β's dtypes where the kernels
    write those, else f32, which the wrappers cast), the kernels' scratch of partial sums,
    and the C arguments of both dtypes."""
    d_alpha, d_beta = (torch.empty(c, dtype=v.dtype if v.dtype in _DTYPES else torch.float32,
                                   device=device) for v in (alpha, beta))
    partial = torch.empty(2 * b * -(-t // run) * c, dtype=torch.float32, device=device)
    return d_alpha, d_beta, partial, (_DTYPES[d_alpha.dtype], _DTYPES[d_beta.dtype])


def _launch_fused_vjp(x, alpha, beta, g, taps: int):
    _check("anti_alias_snake_vjp", taps, x, g)
    b, t, c = x.shape
    x, g = x.contiguous(), g.contiguous()
    a, bt = _params(alpha, beta, c, x.device)
    run = _vjp_run_len(b, t, c, _sm_count(x.device))
    dx = torch.empty_like(x)
    d_alpha, d_beta, partial, codes = _param_grads(alpha, beta, b, t, c, run, x.device)
    fn = _build.function("anti_alias", "sf_aa_snake_fused_vjp",
                         [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), g.data_ptr(), a.data_ptr(), bt.data_ptr(),
             _filter_on(taps, str(x.device)).data_ptr(), dx.data_ptr(), d_alpha.data_ptr(),
             d_beta.data_ptr(), partial.data_ptr(), b, t, c, taps, run, _DTYPES[x.dtype],
             *codes, _stream(x))
    _build.check(err, "sf_aa_snake_fused_vjp")
    _VJP_COUNTERS["anti_alias_snake_vjp"].launches += 1
    return dx, d_alpha.to(alpha.dtype), d_beta.to(beta.dtype)


def _launch_downsample_vjp(y_even, y_odd, alpha, beta, g, taps: int):
    _check("aa_snake_downsample_vjp", taps, y_even, y_odd, g)
    b, t, c = y_even.shape
    y_even, y_odd, g = y_even.contiguous(), y_odd.contiguous(), g.contiguous()
    a, bt = _params(alpha, beta, c, g.device)
    run = _vjp_run_len(b, t, c, _sm_count(g.device))
    dy_even, dy_odd = torch.empty_like(y_even), torch.empty_like(y_odd)
    d_alpha, d_beta, partial, codes = _param_grads(alpha, beta, b, t, c, run, g.device)
    fn = _build.function("anti_alias", "sf_aa_snake_downsample_vjp",
                         [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    err = fn(y_even.data_ptr(), y_odd.data_ptr(), g.data_ptr(), a.data_ptr(), bt.data_ptr(),
             _filter_on(taps, str(g.device)).data_ptr(), dy_even.data_ptr(),
             dy_odd.data_ptr(), d_alpha.data_ptr(), d_beta.data_ptr(), partial.data_ptr(),
             b, t, c, taps, run, _DTYPES[g.dtype], *codes, _stream(g))
    _build.check(err, "sf_aa_snake_downsample_vjp")
    _VJP_COUNTERS["aa_snake_downsample_vjp"].launches += 1
    return dy_even, dy_odd, d_alpha.to(alpha.dtype), d_beta.to(beta.dtype)


def _launch_upsample_vjp(g_even, g_odd, taps: int) -> torch.Tensor:
    g_even, g_odd = (None if v is None else v.contiguous() for v in (g_even, g_odd))
    present = [v for v in (g_even, g_odd) if v is not None]
    _check("aa_upsample_fir_vjp", taps, *present)
    g = present[0]
    b, t, c = g.shape
    dx = torch.empty_like(g)
    fn = _build.function("anti_alias", "sf_aa_upsample_fir_vjp",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    err = fn(None if g_even is None else g_even.data_ptr(),
             None if g_odd is None else g_odd.data_ptr(),
             _filter_on(taps, str(g.device)).data_ptr(), dx.data_ptr(), b, t, c, taps,
             _vjp_run_len(b, t, c, _sm_count(g.device), 16), _DTYPES[g.dtype], _stream(g))
    _build.check(err, "sf_aa_upsample_fir_vjp")
    _VJP_COUNTERS["aa_upsample_fir_vjp"].launches += 1
    return dx


# -- the VJPs (the backward of the Functions below) --------------------------------


def aa_upsample_fir_vjp(g_even: tp.Optional[torch.Tensor], g_odd: tp.Optional[torch.Tensor],
                        taps: int = 12) -> torch.Tensor:
    """dx of stage 1 from the cotangents of its (even, odd) outputs (either may
    be None, i.e. zero): on CUDA tensors the kernel, in the cotangents' dtype
    (launches counted in ``aa_upsample_fir_vjp.launches``), else the plain
    version, in f32."""
    present = [v for v in (g_even, g_odd) if v is not None]
    if not present or present[0].device.type != "cuda":
        return aa_upsample_fir_vjp_reference(g_even, g_odd, taps)
    return _launch_upsample_vjp(g_even, g_odd, taps)


def aa_snake_downsample_vjp(y_even: torch.Tensor, y_odd: torch.Tensor, alpha: torch.Tensor,
                            beta: torch.Tensor, g: torch.Tensor, taps: int = 12
                            ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(dy_even, dy_odd, dα, dβ) of the snake and stage 2, each in its input's
    dtype: the kernel on CUDA tensors (launches counted in
    ``aa_snake_downsample_vjp.launches``), else the plain version."""
    if g.device.type != "cuda":
        return aa_snake_downsample_vjp_reference(y_even, y_odd, alpha, beta, g, taps)
    return _launch_downsample_vjp(y_even, y_odd, alpha, beta, g, taps)


def anti_alias_snake_vjp(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                         g: torch.Tensor, taps: int = 12
                         ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dα, dβ) of the fused entry, each in its input's dtype: the kernel on
    CUDA tensors (stage 1 recomputed in its registers; launches counted in
    ``anti_alias_snake_vjp.launches``), else the plain version."""
    if g.device.type != "cuda":
        return anti_alias_snake_vjp_reference(x, alpha, beta, g, taps)
    return _launch_fused_vjp(x, alpha, beta, g, taps)


class _AntiAliasSnakeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha, beta, taps):
        ctx.taps = taps
        with span("op.aa_snake"):
            # the kernels read (B, T, C) rows and the head's activations are transposed views
            # of its convolutions' outputs: x is copied once, and the VJP reads the copy
            x = x.contiguous()
            ctx.save_for_backward(x, alpha, beta)
            return _launch_fused(x, alpha, beta, taps)

    @staticmethod
    def backward(ctx, g):
        x, alpha, beta = ctx.saved_tensors
        with span("op.aa_snake.vjp"):
            return (*anti_alias_snake_vjp(x, alpha, beta, g, ctx.taps), None)


class _UpsampleFirFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps):
        ctx.taps, ctx.dtype = taps, x.dtype
        with span("op.aa_upsample"):
            return _launch_upsample(x, taps)

    @staticmethod
    def backward(ctx, g_even, g_odd):
        with span("op.aa_upsample.vjp"):
            return aa_upsample_fir_vjp(g_even, g_odd, ctx.taps).to(ctx.dtype), None


class _SnakeDownsampleFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y_even, y_odd, alpha, beta, taps):
        ctx.save_for_backward(y_even, y_odd, alpha, beta)
        ctx.taps = taps
        with span("op.aa_snake_down"):
            return _launch_downsample(y_even, y_odd, alpha, beta, taps)

    @staticmethod
    def backward(ctx, g):
        y_even, y_odd, alpha, beta = ctx.saved_tensors
        with span("op.aa_snake_down.vjp"):
            return (*aa_snake_downsample_vjp(y_even, y_odd, alpha, beta, g, ctx.taps),
                    None)


# -- entries --------------------------------------------------------------------


def anti_alias_snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                     taps: int = 12) -> torch.Tensor:
    """x (B, T, C) float32/bfloat16; alpha/beta (C,) log-scale -> (B, T, C).
    CUDA launches are counted in ``anti_alias_snake.launches``."""
    if x.device.type == "cpu":
        return anti_alias_snake_reference(x, alpha, beta, taps)
    return _AntiAliasSnakeFn.apply(x, alpha, beta, taps)


def aa_upsample_fir(x: torch.Tensor, taps: int = 12
                    ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 as (even, odd) phase signals at input rate, in x's dtype.
    CUDA launches are counted in ``aa_upsample_fir.launches``."""
    if x.device.type == "cpu":
        return aa_upsample_fir_reference(x, taps)
    return _UpsampleFirFn.apply(x, taps)


def aa_snake_downsample(y_even: torch.Tensor, y_odd: torch.Tensor,
                        alpha: torch.Tensor, beta: torch.Tensor,
                        taps: int = 12) -> torch.Tensor:
    """Snake + stage 2 on a stage-1 pair. CUDA launches are counted in
    ``aa_snake_downsample.launches``."""
    if y_even.device.type == "cpu":
        return aa_snake_downsample_reference(y_even, y_odd, alpha, beta, taps)
    return _SnakeDownsampleFn.apply(y_even, y_odd, alpha, beta, taps)


anti_alias_snake.launches = 0
aa_upsample_fir.launches = 0
aa_snake_downsample.launches = 0
anti_alias_snake_vjp.launches = 0
aa_upsample_fir_vjp.launches = 0
aa_snake_downsample_vjp.launches = 0
# The VJP launchers count on these function objects, which a caller's patch of the
# module's names (a planted fault, a counting wrapper) leaves in place.
_VJP_COUNTERS = {fn.__name__: fn for fn in (anti_alias_snake_vjp, aa_upsample_fir_vjp,
                                            aa_snake_downsample_vjp)}
