"""Length regulation as a masked matmul (counterpart of
``speechflow_tpu/ops/length_regulator.py``): the hard one-hot alignment, and the
soft Gaussian one of the ``soft_length_regulator`` option."""

from __future__ import annotations

import typing as tp

import torch

__all__ = ["duration_attention", "length_regulate_hard", "length_regulate_soft"]


def duration_attention(durations: torch.Tensor, t_out: int) -> torch.Tensor:
    """Hard one-hot alignment (B, t_out, N) from integer durations (B, N).

    Frame t attends token n iff cum[n-1] <= t < cum[n]; frames beyond the
    total duration attend nothing (zero rows).
    """
    d = durations.float()
    cum = torch.cumsum(d, dim=-1)
    prev = cum - d
    t = torch.arange(t_out, dtype=torch.float32, device=d.device)[None, :, None]
    return ((t >= prev[:, None, :]) & (t < cum[:, None, :])).float()


def length_regulate_hard(content: torch.Tensor, durations: torch.Tensor,
                         t_out: int) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, D) content + (B, N) durations -> ((B, t_out, D), attn)."""
    attn = duration_attention(durations, t_out)
    return torch.matmul(attn.to(content.dtype), content), attn


def length_regulate_soft(content: torch.Tensor, durations: torch.Tensor, t_out: int,
                         sigma: float = 10.0, token_mask: tp.Optional[torch.Tensor] = None
                         ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable regulator: frame t attends token n with weight
    ∝ exp(-sigma · (t + 0.5 - c_n)² / max(d_n, 1)), c_n the token's centre from
    the cumulative durations, normalised over n (tokens outside ``token_mask``
    get none)."""
    dur = durations.float()
    cum = torch.cumsum(dur, dim=-1)
    centers = cum - 0.5 * dur
    t = torch.arange(t_out, dtype=torch.float32, device=dur.device)[None, :, None] + 0.5
    logits = -sigma * (t - centers[:, None, :]) ** 2 / torch.clamp(dur[:, None, :], min=1.0)
    if token_mask is not None:
        logits = torch.where(token_mask[:, None, :], logits, torch.full_like(logits, -1e9))
    attn = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    attn = attn / torch.clamp(attn.sum(dim=-1, keepdim=True), min=1e-9)
    return torch.matmul(attn.to(content.dtype), content), attn
