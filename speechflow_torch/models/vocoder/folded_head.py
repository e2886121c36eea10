"""Folded (space-to-depth) inference head for the BigVGAN-class vocoder
(counterpart of ``speechflow_tpu/models/vocoder/folded_head.py``).

``FoldedSnakeHead`` rebuilds an exact inference equivalent of a loaded
``SnakeUpsampleHead``: once a stage's channel count drops below
``threshold``, its activation is kept folded as (B, T/F, F·C) with F chosen
so that F·C stays at most ``target`` (C halves and F doubles from stage to
stage, so the folded width stays constant). Its ConvTranspose and dilated
convs run on exactly scattered folded kernels (``ops.folded``); its
anti-aliased snakes launch the same hand-written kernels as the unfolded
head, on the unfolded view of the same memory. Wider stages keep the
original modules.

A load-time transform: scatter the weights after loading them. The folded
kernels are scattered in float32 from the head's weights, then cast to the
head's dtype. Module and parameter names are the JAX module's (``inner``,
``ups_f.N.w_f``/``bias_f``, ``res_f.N.M.convs.K.w_f``,
``res_f.N.M.acts.K.alpha_f``/``beta_f``, ``post_act_f``, ``post_f``), with the
folded kernels in flax's (K', W_in, W_out) layout, so
``speechflow_torch.convert.load_nnx_state`` loads a folded JAX state as is.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn as nn

from speechflow_torch.models.vocoder.heads import SnakeUpsampleHead
from speechflow_torch.ops import folded as fd

__all__ = ["FoldedSnakeHead"]


def _divisor_fold(prod_rates: int, c: int, target: int) -> int:
    """Largest divisor F of ``prod_rates`` with F·C <= target (at least 1): F
    divides the cumulative upsampling, so T/F is whole for any frame count."""
    return max(f for f in range(1, prod_rates + 1) if prod_rates % f == 0
               and (f == 1 or f * c <= target))


def _flax_kernel(weight: torch.Tensor) -> np.ndarray:
    """A port (Cout, Cin, K) conv weight as flax's (K, Cin, Cout), float32."""
    return weight.detach().float().cpu().numpy().transpose(2, 1, 0)


def _param(array: np.ndarray, like: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(torch.from_numpy(np.ascontiguousarray(array)).to(
        device=like.device, dtype=like.dtype), requires_grad=False)


class _FoldedConv(nn.Module):
    def __init__(self, conv: nn.Module, f: int, dilation: int = 1):
        super().__init__()
        w_f, self.pad = fd.fold_conv_kernel(_flax_kernel(conv.weight), f, dilation)
        self.w_f = _param(w_f, conv.weight)
        self.bias_f = _param(np.tile(conv.bias.detach().float().cpu().numpy(), f), conv.bias)

    def forward(self, xf: torch.Tensor) -> torch.Tensor:
        return fd.folded_conv(xf, self.w_f, self.pad, self.bias_f)


class _FoldedConvT(nn.Module):
    def __init__(self, up: nn.Module, f_in: int, stride: int):
        super().__init__()
        w_f, self.pad = fd.fold_conv_transpose_kernel(_flax_kernel(up.weight), f_in, stride)
        self.w_f = _param(w_f, up.weight)
        self.bias_f = _param(np.tile(up.bias.detach().float().cpu().numpy(), stride * f_in),
                             up.bias)

    def forward(self, xf: torch.Tensor) -> torch.Tensor:
        return fd.folded_conv(xf, self.w_f, self.pad, self.bias_f)


class _FoldedSnake(nn.Module):
    def __init__(self, act: nn.Module, f: int):
        super().__init__()
        self.alpha_f = _param(np.tile(act.alpha.detach().float().cpu().numpy(), f), act.alpha)
        self.beta_f = _param(np.tile(act.beta.detach().float().cpu().numpy(), f), act.beta)
        self.taps = act.taps

    def forward(self, xf: torch.Tensor, c: int) -> torch.Tensor:
        return fd.folded_anti_alias_snake(xf, self.alpha_f, self.beta_f, c, self.taps)

    def from_shared(self, y_even: torch.Tensor, y_odd: torch.Tensor, c: int) -> torch.Tensor:
        return fd.folded_aa_snake_downsample(y_even, y_odd, self.alpha_f, self.beta_f, c,
                                             self.taps)


class _FoldedResBlock(nn.Module):
    def __init__(self, res: nn.Module, f: int, channels: int):
        super().__init__()
        self.convs = nn.ModuleList(_FoldedConv(c, f, c.dilation[0]) for c in res.convs)
        self.acts = nn.ModuleList(_FoldedSnake(a, f) for a in res.acts)
        self.c = channels

    def forward(self, xf: torch.Tensor, shared_stage1=None) -> torch.Tensor:
        for i, (act, conv) in enumerate(zip(self.acts, self.convs)):
            a = act.from_shared(*shared_stage1, self.c) \
                if i == 0 and shared_stage1 is not None else act(xf, self.c)
            xf = xf + conv(a)
        return xf


class FoldedSnakeHead(nn.Module):
    """Exact folded-inference equivalent of a loaded ``SnakeUpsampleHead``:
    (B, T_frames, dim) -> (B, T_frames·prod(rates)), like the head."""

    def __init__(self, head: SnakeUpsampleHead, target: int = 384, threshold: int = 256):
        super().__init__()
        self.inner = head
        self.taps = head.taps
        self.total_upsample = head.total_upsample
        geom: tp.List[tp.Tuple[int, int, int]] = []
        ups_f, res_f = [], []
        prod, f_prev = 1, 1
        for up, grp in zip(head.ups, head.resblocks):
            r = up.stride
            prod *= r
            c = up.weight.shape[0]
            f = 1 if c >= threshold else _divisor_fold(prod, c, target)
            if f > 1:
                ups_f.append(_FoldedConvT(up, f_prev, r))
                res_f.append(nn.ModuleList(_FoldedResBlock(res, f, c) for res in grp))
            geom.append((r, c, f))
            f_prev = f
        self.geom = tuple(geom)  # per stage: (rate, channels, fold)
        self.ups_f = nn.ModuleList(ups_f)
        self.res_f = nn.ModuleList(res_f)
        _, self.c_last, self.f_last = self.geom[-1]
        if self.f_last > 1:
            self.post_act_f = _FoldedSnake(head.post_act, self.f_last)
            self.post_f = _FoldedConv(head.post, self.f_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        head = self.inner
        x = head.pre(x)
        k = 0
        for (_, c, f), up, grp in zip(self.geom, head.ups, head.resblocks):
            if f == 1:
                x = head.mrf(grp, up(x))
                continue
            # the ConvT emits fold r·F_in (an unfolded input is fold 1); refold
            # to this stage's F if that differs (a reshape)
            xf = self.ups_f[k](x)
            if xf.shape[-1] != f * c:
                xf = fd.fold(fd.unfold(xf, c), f)
            x = self._mrf_folded(self.res_f[k], xf, c)
            k += 1
        if self.f_last > 1:
            xf = self.post_f(self.post_act_f(x, self.c_last))  # (B, S, F·1)
            return torch.tanh(xf).reshape(xf.shape[0], -1)
        return torch.tanh(head.post(head.post_act(x)))[..., 0]

    def _mrf_folded(self, grp: nn.ModuleList, xf: torch.Tensor, c: int) -> torch.Tensor:
        s1 = fd.folded_aa_upsample_fir(xf, c, self.taps) if len(grp) > 1 else None
        acc = grp[0](xf, shared_stage1=s1)
        for res in grp[1:]:
            acc = acc + res(xf, shared_stage1=s1)
        return acc / len(grp)
