"""Monotonic alignment search (counterpart of ``speechflow_tpu/ops/mas.py``).

The forward dynamic programme ``Q[i, j] = value[i, j] + max(Q[i, j-1],
Q[i-1, j-1])`` runs on the tensor's device, one vectorised step a mel frame
over the batch and the text axis, in the arithmetic JAX's scan does (so the
same float32 sums). The backtrace needs one text index a frame: its decisions
(``Q[i-1, j-1] > Q[i, j-1]``, a tie stays on the same token, as JAX's) are
computed on the device in one pass, and the walk over them runs on the host.
Both stop at the longest sequence's last frame; the frames after it are zero.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

__all__ = ["maximum_path"]

_NEG = -1e9


@torch.no_grad()
def maximum_path(value: torch.Tensor, text_lengths: tp.Optional[torch.Tensor] = None,
                 mel_lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T_text, T_mel) log-likelihoods -> the (B, T_text, T_mel) one-hot path
    (value's dtype): one text index a valid frame, non-decreasing, from (0, 0) to
    (text_len - 1, mel_len - 1); zero past the lengths."""
    b, tx, ty = value.shape
    dev = value.device
    if text_lengths is None:
        text_lengths = torch.full((b,), tx, dtype=torch.int64, device=dev)
    if mel_lengths is None:
        mel_lengths = torch.full((b,), ty, dtype=torch.int64, device=dev)
    text_idx = torch.arange(tx, device=dev)
    v = torch.where((text_idx[None, :] < text_lengths.to(dev)[:, None])[:, :, None],
                    value.float(), torch.tensor(_NEG, device=dev))
    mel_len = mel_lengths.cpu().numpy().astype(np.int64)
    # frames past every sequence's end neither reach a path nor hold one: the programme
    # stops at the longest (a collate's padding can be most of the frames)
    t_run = int(min(max(mel_len.max(initial=1), 1), ty))
    q = torch.where(text_idx[None, :] == 0, v[:, :, 0], torch.tensor(_NEG, device=dev))
    qs = [q]
    neg = q.new_full((b, 1), _NEG)
    for j in range(1, t_run):
        q = v[:, :, j] + torch.maximum(q, torch.cat([neg, q[:, :-1]], dim=1))
        qs.append(q)
    q_all = torch.stack(qs)                                   # (T_run, B, Tx)
    # up[j, b, i]: frame j-1 of a path at token i of frame j came from token i-1
    up = torch.zeros_like(q_all, dtype=torch.bool)
    up[1:, :, 1:] = q_all[:-1, :, :-1] > q_all[:-1, :, 1:]
    up = up.cpu().numpy()
    i_end = text_lengths.cpu().numpy().astype(np.int64) - 1
    rows = np.arange(b)
    idx = np.zeros((t_run, b), np.int64)
    active = np.zeros((t_run, b), bool)
    i_cur = i_end.copy()
    for j in range(t_run - 1, -1, -1):
        act = j < mel_len
        i_here = np.where(j == mel_len - 1, i_end, i_cur)
        idx[j], active[j] = i_here, act
        move = up[j, rows, np.clip(i_here, 0, tx - 1)] & (i_here > 0)
        i_cur = np.where(act & (j > 0), np.where(move, i_here - 1, i_here), i_here)
    idx_t = torch.from_numpy(idx.T).to(dev)                   # (B, T_run)
    act_t = torch.from_numpy(active.T).to(dev)
    path = (text_idx[None, :, None] == idx_t[:, None, :]) & act_t[:, None, :]
    return torch.nn.functional.pad(path.to(value.dtype), (0, ty - t_run))
