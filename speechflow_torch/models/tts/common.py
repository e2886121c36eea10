"""Acoustic-model building blocks (counterpart of
``speechflow_tpu/models/tts/common.py``): channels-last and masked.

Dropout follows the JAX blocks: each block takes ``deterministic`` (True by
default, the inference call) and drops at its rate only when it is False,
at the sites the JAX blocks drop (after a conv block's activation, a
transformer block's attention weights and both residual branches, a DiT
block's attention weights). ``PreNet`` and ``MixStyle`` are ported as JAX
has them, though neither package builds either in a model.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.models.layers import Conv1d, MultiHeadAttention, flax_init_, layer_norm

__all__ = ["sinusoidal_embedding", "rope_rotate", "gelu", "dropout", "ConvBlock", "ConvStack",
           "PreNet", "AdaLayerNorm", "FiLM", "ConditionalLayer", "TransformerBlock",
           "DiTBlock", "VectorQuantizer", "VarianceEmbedding", "MixStyle", "MixStyleDraws",
           "grad_reverse"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``nnx.gelu``: the tanh approximation (torch's default is erf)."""
    return F.gelu(x, approximate="tanh")


def dropout(x: torch.Tensor, rate: float, deterministic: bool) -> torch.Tensor:
    """``nnx.Dropout``: the identity when ``deterministic`` or at rate 0."""
    if deterministic or rate == 0.0:
        return x
    return F.dropout(x, rate, training=True)


def _freqs(half: int, max_period: float, device) -> torch.Tensor:
    return torch.exp(-math.log(max_period)
                     * torch.arange(half, dtype=torch.float32, device=device) / half)


def sinusoidal_embedding(positions: torch.Tensor, dim: int,
                         max_period: float = 10000.0) -> torch.Tensor:
    """(...,) -> (..., dim) f32 sin/cos embedding (timesteps, positions)."""
    args = positions[..., None].float() * _freqs(dim // 2, max_period, positions.device)
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def rope_rotate(x: torch.Tensor, max_period: float = 10000.0,
                positions: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """Half-split rotary embedding over (..., T, D) at ``positions`` (shape
    (T,); 0..T-1 by default, a decode step passes its absolute position),
    computed in f32 and returned in x's dtype."""
    t, d = x.shape[-2], x.shape[-1]
    half = d // 2
    pos = (torch.arange(t, dtype=torch.float32, device=x.device) if positions is None
           else positions.to(x.device, torch.float32))
    angles = pos[:, None] * _freqs(half, max_period, x.device)[None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:2 * half]
    parts = [x1 * cos - x2 * sin, x1 * sin + x2 * cos]
    if d % 2:
        parts.append(xf[..., -1:])
    return torch.cat(parts, dim=-1).to(x.dtype)


class ConvBlock(nn.Module):
    """Dilated conv (SAME, or with ``causal`` padded on the left only, flax's
    ``"CAUSAL"``) -> LayerNorm -> ``activation`` (``relu``, ``gelu`` (flax's
    tanh form), ``tanh``; any other name: none) -> dropout."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int = 5,
                 dilation: int = 1, causal: bool = False, activation: str = "relu",
                 dropout: float = 0.1):
        super().__init__()
        self.conv = Conv1d(dim_in, dim_out, kernel_size, dilation=dilation)
        self.norm = layer_norm(dim_out)
        self.causal = causal
        self.activation = activation
        self.dropout = dropout

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        if self.causal:
            pad = (self.conv.kernel_size[0] - 1) * self.conv.dilation[0]
            x = nn.Conv1d.forward(self.conv, F.pad(x.transpose(1, 2), (pad, 0))).transpose(1, 2)
        else:
            x = self.conv(x)
        x = self.norm(x)
        if self.activation == "relu":
            x = F.relu(x)
        elif self.activation == "gelu":
            x = gelu(x)
        elif self.activation == "tanh":
            x = torch.tanh(x)
        return dropout(x, self.dropout, deterministic)


class ConvStack(nn.Module):
    def __init__(self, dim_in: int, dim: int, dim_out: int, n_layers: int = 3,
                 kernel_size: int = 5, dropout: float = 0.1):
        super().__init__()
        dims = [dim_in] + [dim] * (n_layers - 1) + [dim_out]
        self.blocks = nn.ModuleList(
            ConvBlock(dims[i], dims[i + 1], kernel_size, dropout=dropout)
            for i in range(n_layers))

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, deterministic)
        return x


class PreNet(nn.Module):
    """Bottleneck MLP: two Linear + ReLU + dropout layers (flax's initialisers)."""

    def __init__(self, dim_in: int, dim: int = 256, dim_out: int = 256, dropout: float = 0.5):
        super().__init__()
        self.l1 = nn.Linear(dim_in, dim)
        self.l2 = nn.Linear(dim, dim_out)
        self.dropout = dropout
        flax_init_(self)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        x = dropout(F.relu(self.l1(x)), self.dropout, deterministic)
        return dropout(F.relu(self.l2(x)), self.dropout, deterministic)


def _modulation(proj: nn.Linear, cond: torch.Tensor, ndim: int):
    scale, shift = proj(cond).chunk(2, dim=-1)
    while scale.ndim < ndim:
        scale, shift = scale[:, None], shift[:, None]
    return scale, shift


class AdaLayerNorm(nn.Module):
    """LayerNorm (no affine) with condition-predicted scale and shift (the
    projection zero under ``flax_init_``, as JAX's: the identity modulation)."""

    zero_init = ("proj",)

    def __init__(self, dim: int, cond_dim: int):
        super().__init__()
        self.norm = layer_norm(dim, affine=False)
        self.proj = nn.Linear(cond_dim, 2 * dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        scale, shift = _modulation(self.proj, cond, x.ndim)
        return self.norm(x) * (1.0 + scale) + shift


class FiLM(nn.Module):
    def __init__(self, dim: int, cond_dim: int):
        super().__init__()
        self.proj = nn.Linear(cond_dim, 2 * dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        scale, shift = _modulation(self.proj, cond, x.ndim)
        return x * (1.0 + scale) + shift


class ConditionalLayer(nn.Module):
    """cat / add / adanorm / film conditioning on a global (B, C) or
    per-position (B, T, C) condition."""

    def __init__(self, method: str, dim: int, cond_dim: int):
        super().__init__()
        self.method = method
        if method == "cat":
            self.proj = nn.Linear(dim + cond_dim, dim)
        elif method == "add":
            self.proj = nn.Linear(cond_dim, dim)
        elif method == "adanorm":
            self.layer = AdaLayerNorm(dim, cond_dim)
        elif method == "film":
            self.layer = FiLM(dim, cond_dim)
        else:
            raise ValueError(f"unknown condition method: {method}")

    def forward(self, x: torch.Tensor, cond: tp.Optional[torch.Tensor]) -> torch.Tensor:
        if cond is None:
            return x
        cond_t = cond[:, None, :].expand(x.shape[0], x.shape[1], cond.shape[-1]) \
            if cond.ndim == 2 else cond
        if self.method == "cat":
            return self.proj(torch.cat([x, cond_t], dim=-1))
        if self.method == "add":
            return x + self.proj(cond_t)
        return self.layer(x, cond)


class TransformerBlock(nn.Module):
    """Pre-LN MHA + FFN with RoPE on the normed hidden state before q/k/v;
    ``dropout`` on the attention weights and on both residual branches."""

    def __init__(self, dim: int, n_heads: int = 4, ffn_mult: int = 4,
                 dropout: float = 0.1, use_rope: bool = True):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = MultiHeadAttention(dim, n_heads, dropout)
        self.norm2 = layer_norm(dim)
        self.ffn1 = nn.Linear(dim, ffn_mult * dim)
        self.ffn2 = nn.Linear(ffn_mult * dim, dim)
        self.dropout = dropout
        self.use_rope = use_rope

    def forward(self, x: torch.Tensor, valid: tp.Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        h = self.norm1(x)
        if self.use_rope:
            h = rope_rotate(h)
        x = x + dropout(self.attn(h, valid, deterministic), self.dropout, deterministic)
        h = self.ffn2(gelu(self.ffn1(self.norm2(x))))
        return x + dropout(h, self.dropout, deterministic)


class DiTBlock(nn.Module):
    """AdaNorm-modulated attention + MLP with gated residuals; ``dropout`` on
    the attention weights only. The modulation is zero under ``flax_init_``, as
    JAX's."""

    zero_init = ("mod",)

    def __init__(self, dim: int, cond_dim: int, n_heads: int = 4, ffn_mult: int = 4,
                 dropout: float = 0.0):
        super().__init__()
        self.mod = nn.Linear(cond_dim, 6 * dim)
        self.norm1 = layer_norm(dim, affine=False)
        self.attn = MultiHeadAttention(dim, n_heads, dropout)
        self.norm2 = layer_norm(dim, affine=False)
        self.ffn1 = nn.Linear(dim, ffn_mult * dim)
        self.ffn2 = nn.Linear(ffn_mult * dim, dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                valid: tp.Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        sh1, sc1, g1, sh2, sc2, g2 = self.mod(cond)[:, None, :].chunk(6, dim=-1)
        h = rope_rotate(self.norm1(x) * (1 + sc1) + sh1)
        x = x + g1 * self.attn(h, valid, deterministic)
        h = self.norm2(x) * (1 + sc2) + sh2
        return x + g2 * self.ffn2(gelu(self.ffn1(h)))


class VectorQuantizer(nn.Module):
    """Nearest-codeword quantizer: argmin of squared distances, the
    straight-through estimator, and the codebook loss plus ``beta`` times the
    commitment loss. The codebook starts N(0, 1), as JAX's (``flax_init_``
    leaves a bare parameter as constructed)."""

    def __init__(self, codebook_size: int = 256, dim: int = 256, beta: float = 0.25):
        super().__init__()
        self.codebook = nn.Parameter(torch.randn(codebook_size, dim))
        self.beta = beta

    def forward(self, x: torch.Tensor
                ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(..., D) -> (quantized (..., D), codes (...), loss)."""
        cb = self.codebook
        d = ((x ** 2).sum(-1, keepdim=True) - 2 * torch.einsum("...d,kd->...k", x, cb)
             + (cb ** 2).sum(-1))
        idx = d.argmin(-1)
        q = cb[idx]
        commit = ((q.detach() - x) ** 2).mean()
        codebook_loss = ((q - x.detach()) ** 2).mean()
        return x + (q - x).detach(), idx, codebook_loss + self.beta * commit


class VarianceEmbedding(nn.Module):
    """A scalar variance bucketed into ``n_bins`` over ``interval`` and embedded:
    bin = clip(int((x - lo) / (hi - lo) · n_bins), 0, n_bins - 1), the cast
    truncating toward zero as JAX's ``astype(int32)``; ``log_scale`` takes
    log1p(max(x, 0)) and log1p of the interval first."""

    def __init__(self, interval: tp.Tuple[float, float] = (0.0, 880.0), n_bins: int = 256,
                 emb_dim: int = 64, log_scale: bool = False):
        super().__init__()
        self.interval = tuple(float(v) for v in interval)
        self.n_bins = n_bins
        self.log_scale = log_scale
        self.emb = nn.Embedding(n_bins, emb_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.interval
        x = x.float()
        if self.log_scale:
            x = torch.log1p(torch.clamp(x, min=0.0))
            lo, hi = math.log1p(max(lo, 0.0)), math.log1p(hi)
        # float32 division first, as JAX computes it (a float64 bound would move
        # values on a bin edge)
        scaled = (x - torch.tensor(lo, dtype=torch.float32)) / torch.tensor(
            hi - lo, dtype=torch.float32) * self.n_bins
        idx = torch.clamp(scaled.to(torch.int32), 0, self.n_bins - 1)
        return self.emb(idx.long())


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.scale * g, None


def grad_reverse(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """The identity whose gradient is -scale times the incoming one."""
    return _GradReverse.apply(x, scale)


class MixStyleDraws(tp.NamedTuple):
    """A ``MixStyle`` call's draws: the Beta(α, α) weights (B, 1, 1), the batch
    permutation (B,), and whether the call mixes at all (a 0-dim bool)."""

    lmda: torch.Tensor
    perm: torch.Tensor
    gate: torch.Tensor


class MixStyle(nn.Module):
    """Feature-statistics mixing (Zhou et al., ICLR 2021): with probability ``p``
    each sequence of (B, T, C) is normalised by its own time-axis mean and std
    and takes a Beta(α, α)-weighted mix of its statistics and a shuffled batch
    partner's; the statistics take no gradient, as JAX's ``stop_gradient``.
    The identity outside training. The draws come from ``draw`` (a
    ``torch.Generator`` where given) or are injected as ``draws``."""

    def __init__(self, p: float = 0.5, alpha: float = 0.1, eps: float = 1e-6):
        super().__init__()
        self.p, self.alpha, self.eps = p, alpha, eps

    def draw(self, batch: int, device: torch.device,
             generator: tp.Optional[torch.Generator] = None) -> MixStyleDraws:
        """A call's draws from ``generator`` (torch's global generator without one;
        the Beta weights from a seed the generator draws, as torch's Beta sampler
        takes none)."""
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else [],
                                   enabled=generator is not None):
            if generator is not None:
                seed = torch.randint(2 ** 62, (), generator=generator, device=generator.device)
                torch.manual_seed(int(seed))
            alpha = torch.tensor(float(self.alpha), device=device)
            lmda = torch.distributions.Beta(alpha, alpha).sample((batch, 1, 1))
        perm = torch.randperm(batch, generator=generator, device=device)
        gate = torch.rand((), generator=generator, device=device) < self.p
        return MixStyleDraws(lmda, perm, gate)

    def forward(self, x: torch.Tensor, training: bool = True,
                draws: tp.Optional[MixStyleDraws] = None,
                generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
        if not training:
            return x
        lmda, perm, gate = draws if draws is not None else self.draw(x.shape[0], x.device,
                                                                      generator)
        mu = x.mean(1, keepdim=True).detach()
        sig = torch.sqrt(x.var(1, keepdim=True, unbiased=False) + self.eps).detach()
        lmda = lmda.to(x.dtype)
        mu_mix = mu * lmda + mu[perm] * (1.0 - lmda)
        sig_mix = sig * lmda + sig[perm] * (1.0 - lmda)
        return torch.where(gate, (x - mu) / sig * sig_mix + mu_mix, x)
