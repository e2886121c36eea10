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
the kernel compute in f32 and return the input's dtype. Derivation (taps K,
XLA SAME anchoring pad_left p = (K-1)//2):

  stage 1: y_even[i] = sum_{k-p even} 2 f[k] x[i + (k-p)/2]
           y_odd[i]  = sum_{k-p odd}  2 f[k] x[i + (k-p+1)/2]
  stage 2: out[i] = sum_{k-p even} f[k] z_even[i + (k-p)/2]
                  + sum_{k-p odd}  f[k] z_odd[i + (k-p-1)/2],  z = snake(y)
"""

from __future__ import annotations

import ctypes
import functools
import math
import typing as tp

import numpy as np
import torch

from speechflow_torch.ops import _build

__all__ = ["kaiser_sinc_filter", "anti_alias_snake", "aa_upsample_fir",
           "aa_snake_downsample", "anti_alias_snake_reference",
           "aa_upsample_fir_reference", "aa_snake_downsample_reference"]

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


def _shifter(v: torch.Tensor, m: int):
    t = v.shape[1]
    vp = torch.nn.functional.pad(v, (0, 0, m, m))
    return lambda s: vp[:, m + s: m + s + t]


def _snake(y: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    a = torch.exp(alpha.float())
    inv_b = 1.0 / (torch.exp(beta.float()) + 1e-9)
    return y + inv_b * torch.sin(a * y) ** 2


def _phases_f32(x: torch.Tensor, taps: int) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    filt = kaiser_sinc_filter(taps=taps)
    p = (taps - 1) // 2
    sh = _shifter(x.float(), taps // 2 + 1)
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
    sh_e = _shifter(_snake(y_even.float(), alpha, beta), m)
    sh_o = _shifter(_snake(y_odd.float(), alpha, beta), m)
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


def anti_alias_snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                     taps: int = 12) -> torch.Tensor:
    """x (B, T, C) float32/bfloat16; alpha/beta (C,) log-scale -> (B, T, C).
    CUDA launches are counted in ``anti_alias_snake.launches``."""
    if x.device.type == "cpu":
        return anti_alias_snake_reference(x, alpha, beta, taps)
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


def aa_upsample_fir(x: torch.Tensor, taps: int = 12
                    ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 as (even, odd) phase signals at input rate, in x's dtype.
    CUDA launches are counted in ``aa_upsample_fir.launches``."""
    if x.device.type == "cpu":
        return aa_upsample_fir_reference(x, taps)
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


def aa_snake_downsample(y_even: torch.Tensor, y_odd: torch.Tensor,
                        alpha: torch.Tensor, beta: torch.Tensor,
                        taps: int = 12) -> torch.Tensor:
    """Snake + stage 2 on a stage-1 pair. CUDA launches are counted in
    ``aa_snake_downsample.launches``."""
    if y_even.device.type == "cpu":
        return aa_snake_downsample_reference(y_even, y_odd, alpha, beta, taps)
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


anti_alias_snake.launches = 0
aa_upsample_fir.launches = 0
aa_snake_downsample.launches = 0
