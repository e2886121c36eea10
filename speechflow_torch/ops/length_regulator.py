"""Hard length regulation as a masked matmul (counterpart of
``speechflow_tpu/ops/length_regulator.py``)."""

from __future__ import annotations

import typing as tp

import torch

__all__ = ["duration_attention", "length_regulate_hard"]


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
