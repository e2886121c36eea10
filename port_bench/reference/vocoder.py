"""Plain reference of the BigVGAN-class vocoder: a Vocos ConvNeXt backbone and
BigVGAN's upsampling head (transposed convolutions, each stage followed by the
mean of multi-receptive-field AMP resblocks whose activations are
anti-aliased snakes), unfolded, as the configuration states it.

``log_mel`` is the training recipe's log-mel of a waveform (periodic
Hann, centred reflect padding, Slaney mel filters, log of the magnitude
clipped at 1e-5). Parameter names are the program's (``Vocos``'s state dict
before it folds its head for inference).
"""

from __future__ import annotations

import functools
import math
import typing as tp

import numpy as np
import torch
import torch.nn as nn

from port_bench.reference import nn as R


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, mlp_ratio: int, k: int = 7):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, k, groups=dim)
        self.norm = nn.LayerNorm(dim)
        self.pw1 = nn.Linear(dim, mlp_ratio * dim)
        self.pw2 = nn.Linear(mlp_ratio * dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def __call__(self, x, prec):
        h = R.conv1d(x, self.dwconv.weight, self.dwconv.bias, prec, groups=x.shape[-1])
        h = R.layer_norm(h, self.norm.weight, self.norm.bias, prec)
        h = R.linear(R.gelu(R.linear(h, self.pw1.weight, self.pw1.bias, prec)),
                     self.pw2.weight, self.pw2.bias, prec)
        return x + self.gamma.to(prec.dtype) * h


class Backbone(nn.Module):
    def __init__(self, dim_in: int, dim: int, n_layers: int, mlp_ratio: int):
        super().__init__()
        self.embed = nn.Conv1d(dim_in, dim, 7)
        self.norm_in = nn.LayerNorm(dim)
        self.blocks = nn.ModuleList(ConvNeXtBlock(dim, mlp_ratio) for _ in range(n_layers))
        self.norm_out = nn.LayerNorm(dim)

    def __call__(self, x, prec):
        x = R.layer_norm(R.conv1d(x, self.embed.weight, self.embed.bias, prec),
                         self.norm_in.weight, self.norm_in.bias, prec)
        for blk in self.blocks:
            x = blk(x, prec)
        return R.layer_norm(x, self.norm_out.weight, self.norm_out.bias, prec)


class Snake(nn.Module):
    def __init__(self, channels: int, taps: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.taps = taps

    def __call__(self, x, prec):
        return R.anti_alias_snake(x, self.alpha, self.beta, self.taps).to(prec.dtype)


class ResBlock(nn.Module):
    def __init__(self, channels: int, k: int, taps: int, dilations=(1, 3, 5)):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs = nn.ModuleList(nn.Conv1d(channels, channels, k, dilation=d)
                                   for d in dilations)
        self.acts = nn.ModuleList(Snake(channels, taps) for _ in dilations)

    def __call__(self, x, prec):
        for act, conv, d in zip(self.acts, self.convs, self.dilations):
            x = x + R.conv1d(act(x, prec), conv.weight, conv.bias, prec, dilation=d)
        return x


class TransposedConv(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, k: int, stride: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in, k))
        self.bias = nn.Parameter(torch.zeros(dim_out))
        self.stride = stride

    def __call__(self, x, prec):
        return R.conv_transpose1d(x, self.weight, self.bias, self.stride, prec)


class SnakeHead(nn.Module):
    def __init__(self, dim: int, rates: tp.Sequence[int], channels: int,
                 kernels: tp.Sequence[int], taps: int):
        super().__init__()
        self.pre = nn.Conv1d(dim, channels, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = channels
        for r in rates:
            self.ups.append(TransposedConv(ch, ch // 2, 2 * r, r))
            ch //= 2
            self.resblocks.append(nn.ModuleList(ResBlock(ch, k, taps) for k in kernels))
        self.post_act = Snake(ch, taps)
        self.post = nn.Conv1d(ch, 1, 7)

    def __call__(self, x, prec):
        x = R.conv1d(x, self.pre.weight, self.pre.bias, prec)
        for up, group in zip(self.ups, self.resblocks):
            x = up(x, prec)
            x = sum(res(x, prec) for res in group) / len(group)
        x = R.conv1d(self.post_act(x, prec), self.post.weight, self.post.bias, prec)
        return torch.tanh(x)[..., 0]


class Vocoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        if cfg.get("backbone") != "vocos" or cfg.get("head") != "snake_upsample":
            raise ValueError("the reference builds the vocos backbone and snake_upsample head")
        if cfg.get("cond_dim") is not None:
            raise ValueError("the reference builds no speaker conditioning")
        self.cfg = cfg
        self.backbone = Backbone(cfg["n_mels"], cfg["dim"], cfg["n_layers"],
                                 cfg.get("mlp_ratio", 3))
        self.head = SnakeHead(cfg["dim"], cfg["upsample_rates"], cfg["upsample_channels"],
                              cfg["resblock_kernel_sizes"], cfg.get("snake_taps", 12))

    def from_features(self, feats: torch.Tensor, prec: R.Precision) -> torch.Tensor:
        """(B, T, n_mels) -> (B, (T-1)·hop)."""
        wav = self.head(self.backbone(feats.to(prec.dtype), prec), prec)
        return wav[..., : (feats.shape[1] - 1) * self.cfg["hop_length"]]


# -- the training recipe's log-mel -------------------------------------------------


def hann(n: int, device) -> torch.Tensor:
    """Periodic Hann window, float32."""
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def magnitude(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """|STFT| (B, frames, n_fft//2 + 1) of (B, T): centred reflect padding, periodic
    Hann, frames every ``hop``; float32 (float64 for float64 input)."""
    wide = torch.promote_types(x.dtype, torch.float32)
    xp = torch.nn.functional.pad(x.to(wide)[:, None], (n_fft // 2, n_fft // 2),
                                 mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop) * hann(n_fft, x.device).to(wide)
    return torch.fft.rfft(frames, dim=-1).abs()


@functools.lru_cache(maxsize=None)
def slaney_mel(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
               fmax: tp.Optional[float] = None) -> np.ndarray:
    """librosa's default mel filterbank (Slaney scale, Slaney area norm), (n_freq, n_mels)."""
    fmax = sr / 2.0 if fmax is None else fmax

    def hz_to_mel(f):
        f = np.asanyarray(f, dtype=np.float64)
        f_sp = 200.0 / 3
        mels = f / f_sp
        min_log_hz, logstep = 1000.0, math.log(6.4) / 27.0
        min_log_mel = min_log_hz / f_sp
        return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                        / logstep, mels)

    def mel_to_hz(m):
        m = np.asanyarray(m, dtype=np.float64)
        f_sp = 200.0 / 3
        freqs = f_sp * m
        min_log_hz, logstep = 1000.0, math.log(6.4) / 27.0
        min_log_mel = min_log_hz / f_sp
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)

    fft_freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


def log_mel(wav: torch.Tensor, sr: int, n_fft: int, hop: int, n_mels: int) -> torch.Tensor:
    """(B, T) -> (B, T//hop + 1, n_mels): log(max(mel magnitude, 1e-5)) (``maximum``:
    half the gradient at a tie, as ``jnp.clip`` gives it)."""
    mag = magnitude(wav, n_fft, hop)
    fb = torch.as_tensor(slaney_mel(sr, n_fft, n_mels), device=wav.device, dtype=mag.dtype)
    mel = mag @ fb
    return torch.log(torch.maximum(mel, mel.new_tensor(1e-5)))
