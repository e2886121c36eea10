"""Plain reference of the BigVGAN GAN recipe's training step.

- the generator: the vocoder of ``reference.vocoder`` fed the log-mel of the
  waveform (float32);
- the discriminator: the multi-period discriminator (periods 2/3/5/7/11, the
  waveform folded by period, 2-D SAME convolutions with LeakyReLU(0.1)) and
  the multi-scale sub-band CQT discriminator (an octave-recursive constant-Q
  transform of the 2x-upsampled waveform, per-octave pre-convolutions, a
  time-dilated convolution stack);
- the losses: 45 x the log-mel L1, the multi-resolution STFT loss (spectral
  convergence plus log-magnitude L1), the hinge adversarial loss and 2 x the
  feature matching; the discriminator's hinge loss;
- the optimizer: optax's chain as the recipe states it, for each network:
  the running mean of ``grad_accum`` micro-batch gradients, a step only when
  every gradient is finite, the global norm clipped to ``grad_clip``, AdamW
  (decoupled decay) at the warm-up-cosine learning rate of the step count.

Parameter names are the program's (``Vocos`` and ``VocoderDiscriminator``).
"""

from __future__ import annotations

import functools
import math
import typing as tp

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference import nn as R
from port_bench.reference.vocoder import Vocoder, log_mel, magnitude


def leaky(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.1) with slope 1 at exactly 0 (``jnp.where(x >= 0, ...)``)."""
    return torch.where(x >= 0, x, 0.1 * x)


def _same(n: int, k: int, s: int, d: int) -> tp.Tuple[int, int]:
    k_eff = (k - 1) * d + 1
    total = max((-(-n // s) - 1) * s + k_eff - n, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    """Holds a channels-last SAME 2-D convolution's parameters; computes in the
    precision its discriminator sets."""

    prec = R.Precision.reference()

    def __init__(self, c_in: int, c_out: int, k, stride=(1, 1), dilation=(1, 1)):
        super().__init__(c_in, c_out, tuple(k), stride=tuple(stride), dilation=tuple(dilation))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        (h0, h1), (w0, w1) = (_same(n, k, s, d) for n, k, s, d in
                              zip(h.shape[2:], self.kernel_size, self.stride, self.dilation))
        q = self.prec.q
        h = F.conv2d(F.pad(q(h), (w0, w1, h0, h1)), q(self.weight),
                     self.bias.to(self.prec.dtype), self.stride, 0, self.dilation)
        return h.permute(0, 2, 3, 1)


def run_stack(convs, post, x):
    fmaps = []
    for conv in convs:
        x = leaky(conv(x))
        fmaps.append(x)
    logits = post(x)
    fmaps.append(logits)
    return logits.reshape(x.shape[0], -1), fmaps


class PeriodDisc(nn.Module):
    def __init__(self, period: int, c: int):
        super().__init__()
        self.period = period
        chs = [1, c, c * 4, c * 16, c * 32, c * 32]
        self.convs = nn.ModuleList(Conv2d(chs[i], chs[i + 1], (5, 1),
                                          stride=(3, 1) if i < 4 else (1, 1)) for i in range(5))
        self.post = Conv2d(chs[-1], 1, (3, 1))

    def __call__(self, wav):
        b, t = wav.shape
        pad = (-t) % self.period
        x = F.pad(wav[:, None], (0, pad), mode="reflect")[:, 0] if pad else wav
        return run_stack(self.convs, self.post, x.reshape(b, -1, self.period, 1))


class MPD(nn.Module):
    def __init__(self, periods, c):
        super().__init__()
        self.discs = nn.ModuleList(PeriodDisc(p, c) for p in periods)


# -- the constant-Q transform ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _bank(sr: int, fmin: float, n_bins: int, bpo: int) -> tp.Tuple[np.ndarray, int]:
    """The top octave's complex kernels (L, 2·bpo) [real | imag]: Hann-windowed,
    ceil(Q·sr/f) long, centred in a common even length L."""
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bpo)
    freqs = freqs[-bpo:]
    q = 1.0 / (2.0 ** (1.0 / bpo) - 1.0)
    lens = np.ceil(q * sr / freqs).astype(int)
    length = int(2 * np.ceil(lens.max() / 2))
    bank = np.zeros((length, 2 * bpo), np.float32)
    for k, (f, n) in enumerate(zip(freqs, lens)):
        n = int(n)
        start = (length - n) // 2
        t = (np.arange(n) - (n - 1) / 2) / sr
        kern = np.hanning(n) * np.exp(2j * np.pi * f * t) / n
        bank[start:start + n, k] = kern.real
        bank[start:start + n, bpo + k] = kern.imag
    return bank, length


@functools.lru_cache(maxsize=None)
def _halfband(taps: int = 65, beta: float = 8.0) -> np.ndarray:
    n = np.arange(taps) - (taps - 1) / 2
    h = np.sinc(n / 2.0) / 2.0 * np.kaiser(taps, beta)
    return (h / h.sum()).astype(np.float32)


def _fir(x: torch.Tensor, h: torch.Tensor, stride: int = 1) -> torch.Tensor:
    taps = h.shape[0]
    pad = (taps - 1) // 2
    return F.conv1d(F.pad(x[:, None], (pad, taps - 1 - pad)), h[None, None], stride=stride)[:, 0]


def cqt(wav: torch.Tensor, sr: int, hop: int, n_octaves: int, bpo: int,
        fmin: float = 32.703195) -> torch.Tensor:
    """(B, T) -> (B, frames, n_octaves·bpo, 2): the waveform 2x upsampled
    (zero-stuffing and a 65-tap Kaiser half-band FIR, gain 2); per octave, frames
    of the signal times the top octave's bank, then the signal halved (the same
    FIR, stride 2); octaves ascending from fmin. Float32."""
    x = wav.float()
    b, t = x.shape
    fir = torch.as_tensor(_halfband(), device=x.device)
    x = _fir(torch.stack([x, torch.zeros_like(x)], -1).reshape(b, 2 * t), 2.0 * fir)
    bank_np, length = _bank(2 * sr, fmin, n_octaves * bpo, bpo)
    bank = torch.as_tensor(bank_np, device=x.device)
    n_frames = x.shape[-1] // hop + 1
    octaves = []
    for o in range(n_octaves):
        xp = F.pad(x, (length // 2, length // 2))
        z = torch.matmul(xp.unfold(-1, length, hop), bank)[:, :n_frames]
        if z.shape[1] < n_frames:
            z = F.pad(z, (0, 0, 0, n_frames - z.shape[1]))
        re, im = z.chunk(2, dim=-1)
        octaves.append(torch.stack([re, im], dim=-1))
        if o < n_octaves - 1:
            x = _fir(x, fir, stride=2)
            hop //= 2
    return torch.cat(octaves[::-1], dim=2)


class CQTDisc(nn.Module):
    def __init__(self, sr: int, hop: int, n_octaves: int, bpo: int, filters: int,
                 max_filters: int = 1024, dilations=(1, 2, 4)):
        super().__init__()
        self.sr, self.hop, self.n_octaves, self.bpo = sr, hop, n_octaves, bpo
        self.conv_pres = nn.ModuleList(Conv2d(2, 2, (3, 9)) for _ in range(n_octaves))
        convs = [Conv2d(2, filters, (3, 9))]
        c = filters
        for i, d in enumerate(dilations):
            out = min(filters * 2 ** (i + 1), max_filters)
            convs.append(Conv2d(c, out, (3, 9), stride=(1, 2), dilation=(d, 1)))
            c = out
        convs.append(Conv2d(c, c, (3, 3)))
        self.convs = nn.ModuleList(convs)
        self.post = Conv2d(c, 1, (3, 3))

    def __call__(self, wav):
        z = cqt(wav, self.sr, self.hop, self.n_octaves, self.bpo)
        n = self.bpo
        x = torch.cat([pre(z[:, :, o * n:(o + 1) * n]) for o, pre in enumerate(self.conv_pres)],
                      dim=2)
        return run_stack(self.convs, self.post, x)


class CQTDiscs(nn.Module):
    def __init__(self, sr, hops, octaves, bpos, filters):
        super().__init__()
        self.discs = nn.ModuleList(CQTDisc(sr, h, o, b, filters)
                                   for h, o, b in zip(hops, octaves, bpos))


class Discriminator(nn.Module):
    """MPD + the multi-scale sub-band CQT discriminator: (logits, feature maps)."""

    def __init__(self, cfg: dict, prec: R.Precision = R.Precision.reference()):
        super().__init__()
        if not cfg.get("use_cqt"):
            raise ValueError("the reference builds the CQT discriminator (use_cqt) only")
        c = cfg["channels"]
        self.mpd = MPD(cfg["periods"], c)
        self.mrd = CQTDiscs(cfg["sample_rate"], (512, 256, 256), cfg["cqt_n_octaves"],
                            cfg["cqt_bins_per_octave"], c)
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.prec = prec

    def __call__(self, wav):
        """Logits and feature maps in float32 (the transforms in float32 too)."""
        outs = [d(wav) for d in (*self.mpd.discs, *self.mrd.discs)]
        return ([o[0].float() for o in outs], [[f.float() for f in o[1]] for o in outs])


# -- losses ---------------------------------------------------------------------------


def _relu(x):
    return torch.maximum(x, x.new_zeros(()))


def gen_losses(fake, real, disc, loss: dict, sr: int, n_fft: int, hop: int, n_mels: int):
    t = min(fake.shape[-1], real.shape[-1])
    fake, real = fake[..., :t], real[..., :t]
    lm_f, lm_r = (log_mel(w, sr, n_fft, hop, n_mels) for w in (fake, real))
    out = {"mel": loss["mel_weight"] * torch.mean(torch.abs(lm_f - lm_r))}
    stft = 0.0
    for nf, hp in ((512, 128), (1024, 256), (2048, 512)):
        mf, mr = magnitude(fake, nf, hp), magnitude(real, nf, hp)
        sc = torch.linalg.norm(mr - mf) / torch.clamp(torch.linalg.norm(mr.detach()), min=1e-6)
        stft = stft + sc + torch.mean(torch.abs(torch.log(mf + 1e-5) - torch.log(mr + 1e-5)))
    out["stft"] = loss["stft_weight"] * stft / 3
    fl, ff = disc(fake)
    rl, rf = disc(real)
    out["adv"] = loss["adv_weight"] * sum(torch.mean(_relu(1.0 - x)) for x in fl) / len(fl)
    fm, n = 0.0, 0
    for r_maps, f_maps in zip(rf, ff):
        for r, f in zip(r_maps, f_maps):
            fm = fm + torch.mean(torch.abs(r - f))
            n += 1
    out["fm"] = loss["fm_weight"] * fm / n
    return out


def disc_losses(fake, real, disc):
    t = min(fake.shape[-1], real.shape[-1])
    fl, _ = disc(fake[..., :t])
    rl, _ = disc(real[..., :t])
    total = 0.0
    for r, f in zip(rl, fl):
        total = total + torch.mean(_relu(1.0 - r)) + torch.mean(_relu(1.0 + f))
    return {"disc_hinge": total / len(rl)}


# -- the optimizer chain --------------------------------------------------------------


def warmup_cosine(lr: float, warmup: int, decay: int, end_ratio: float = 0.01):
    def at(count: int) -> float:
        if count < warmup:
            return lr * min(max(count, 0), warmup) / warmup
        c = min(count - warmup, decay - warmup)
        return lr * ((1 - end_ratio) * 0.5 * (1 + math.cos(math.pi * c / (decay - warmup)))
                     + end_ratio)
    return at


class Chain:
    """optax's MultiSteps(apply_if_finite(clip -> adamw -> schedule), k) over a
    dict of float32 parameters; ``first_grad`` keeps the gradient its first
    applied step took (after accumulation and clipping)."""

    def __init__(self, params: tp.Dict[str, torch.Tensor], opt: dict):
        self.params = params
        self.opt = opt
        kw = opt.get("lr_schedule_kwargs", {})
        self.lr = warmup_cosine(opt["lr"], kw["warmup_steps"], kw["decay_steps"])
        self.b1, self.b2 = opt.get("betas", (0.9, 0.999))
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.acc = {k: torch.zeros_like(p) for k, p in params.items()}
        self.mini, self.count = 0, 0
        self.first_grad: tp.Optional[tp.Dict[str, torch.Tensor]] = None

    @torch.no_grad()
    def step(self, grads: tp.Dict[str, torch.Tensor]) -> bool:
        n = self.mini
        for k, g in grads.items():
            self.acc[k] += (g - self.acc[k]) / (n + 1)
        self.mini = (n + 1) % self.opt.get("grad_accum", 1)
        if self.mini:
            return False
        g = self.acc
        self.acc = {k: torch.zeros_like(p) for k, p in self.params.items()}
        if not all(bool(torch.isfinite(x).all()) for x in g.values()):
            return False
        clip = self.opt.get("grad_clip")
        if clip:
            norm = torch.sqrt(sum(torch.sum(x ** 2) for x in g.values()))
            if not bool(norm < clip):
                g = {k: x / norm * clip for k, x in g.items()}
        if self.first_grad is None:
            self.first_grad = {k: x.clone() for k, x in g.items()}
        lr, wd, eps = self.lr(self.count), self.opt.get("weight_decay", 1e-6), \
            self.opt.get("eps", 1e-8)
        t = self.count + 1
        for k, p in self.params.items():
            self.m[k].mul_(self.b1).add_(g[k], alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g[k], g[k], value=1 - self.b2)
            p.mul_(1 - lr * wd)
            denom = (self.v[k].sqrt() / math.sqrt(1 - self.b2 ** t)).add_(eps)
            p.addcdiv_(self.m[k], denom, value=-lr / (1 - self.b1 ** t))
        self.count += 1
        return True


class GANStep:
    """The recipe's micro-batch: the generator's losses differentiated for the
    generator (the discriminator fixed), then the discriminator's hinge loss on
    the detached fake and the real waveform; each network's chain takes its
    gradients. ``__call__`` returns the two totals."""

    def __init__(self, cfg: dict, weights_g: dict, weights_d: dict, prec=R.Precision.reference()):
        with torch.device("meta"):
            self.gen = Vocoder(cfg["generator"])
            self.disc = Discriminator(cfg["discriminator"], prec)
        self.gen.load_state_dict({k: v.clone() for k, v in weights_g.items()}, assign=True)
        self.disc.load_state_dict({k: v.clone() for k, v in weights_d.items()}, assign=True)
        self.cfg, self.prec = cfg, prec
        g = cfg["generator"]
        self.mel_args = (g["sample_rate"], g["n_fft"], g["hop_length"], g["n_mels"])
        self.opt_g = Chain(dict(self.gen.named_parameters()), cfg["optimizer"])
        self.opt_d = Chain(dict(self.disc.named_parameters()), cfg["optimizer"])

    def __call__(self, wav: torch.Tensor) -> tp.Tuple[float, float]:
        sr, n_fft, hop, n_mels = self.mel_args
        feats = log_mel(wav, sr, n_fft, hop, n_mels)
        gp = dict(self.gen.named_parameters())
        for p in gp.values():
            p.requires_grad_(True)
        fake = self.gen.from_features(feats, self.prec).float()
        for p in self.disc.parameters():
            p.requires_grad_(False)
        losses = gen_losses(fake, wav, self.disc, self.cfg["loss"], sr, n_fft, hop, n_mels)
        g_total = sum(losses.values())
        grads = torch.autograd.grad(g_total, list(gp.values()), allow_unused=True)
        self.opt_g.step({k: torch.zeros_like(p) if gr is None else gr
                         for (k, p), gr in zip(gp.items(), grads)})
        for p in gp.values():
            p.requires_grad_(False)
        dp = dict(self.disc.named_parameters())
        for p in dp.values():
            p.requires_grad_(True)
        d_total = disc_losses(fake.detach(), wav, self.disc)["disc_hinge"]
        grads = torch.autograd.grad(d_total, list(dp.values()), allow_unused=True)
        self.opt_d.step({k: torch.zeros_like(p) if gr is None else gr
                         for (k, p), gr in zip(dp.items(), grads)})
        for p in dp.values():
            p.requires_grad_(False)
        return float(g_total.detach()), float(d_total.detach())
