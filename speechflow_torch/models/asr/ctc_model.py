"""Trainable CTC phoneme recognizer (counterpart of
``speechflow_tpu/models/asr/ctc_model.py``): strided convs and a
bidirectional GRU over log-mel frames emit per-frame label logits (blank at
index 0), trained with ``training.losses.CTCLoss``; ``greedy_ctc_decode``
collapses repeats, drops blanks and keeps each token's frame span.

Channels-last as the JAX module: the convs are ``nnx.Conv`` with XLA SAME
padding (the first at ``time_stride``: ``models.layers.Conv1d``), each
followed by the tanh GELU and ``nnx.LayerNorm`` (eps 1e-6); the GRUs are
``nnx.RNN`` over every frame, padded ones too (the backward one
``reverse=True, keep_order=True``). The weights start from flax's
initialisers.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.models.layers import RNN, Conv1d, flax_init_, layer_norm
from speechflow_torch.training.base_model import BaseModelParams

__all__ = ["CTCRecognizerParams", "CTCRecognizer", "greedy_ctc_decode"]


@dataclasses.dataclass
class CTCRecognizerParams(BaseModelParams):
    n_symbols: int = 100                 # label space incl. blank at index 0
    sample_rate: int = 24000
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 80
    dim: int = 192
    n_conv: int = 2
    time_stride: int = 2                 # conv downsampling of the frame rate


class CTCRecognizer(nn.Module):
    def __init__(self, params: CTCRecognizerParams):
        super().__init__()
        p = self.p = params
        dims = [p.n_mels] + [p.dim] * p.n_conv
        self.convs = nn.ModuleList(
            Conv1d(dims[i], dims[i + 1], 5, stride=p.time_stride if i == 0 else 1)
            for i in range(p.n_conv))
        self.norms = nn.ModuleList(layer_norm(p.dim) for _ in range(p.n_conv))
        half = p.dim // 2
        self.fwd = RNN("gru", p.dim, half)
        self.bwd = RNN("gru", p.dim, p.dim - half, reverse=True)
        self.head = nn.Linear(p.dim, p.n_symbols)
        flax_init_(self)

    def forward(self, mel: torch.Tensor, lengths: tp.Optional[torch.Tensor] = None
                ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, n_mels) log-mel -> ((B, T', V) logits, (B,) output lengths:
        ceil(lengths / time_stride), at least 1; T' for every row when
        ``lengths`` is None)."""
        x = mel
        for conv, norm in zip(self.convs, self.norms):
            x = norm(F.gelu(conv(x), approximate="tanh"))
        logits = self.head(torch.cat([self.fwd(x), self.bwd(x)], dim=-1))
        if lengths is None:
            out_lens = torch.full((mel.shape[0],), logits.shape[1], dtype=torch.int32,
                                  device=mel.device)
        else:
            s = self.p.time_stride
            out_lens = torch.clamp((lengths + s - 1) // s, min=1).to(torch.int32)
        return logits, out_lens

    def recognize(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) waveform -> (B, T', V) logits (the log-mel on the model's
        device)."""
        from speechflow_torch.ops.mel import amp_to_db, linear_to_mel
        from speechflow_torch.ops.stft import magnitude

        p = self.p
        mel = amp_to_db(linear_to_mel(magnitude(wav, p.n_fft, p.hop_length), p.sample_rate,
                                      p.n_mels))
        return self(mel)[0]


def greedy_ctc_decode(logits, blank_id: int = 0, hop_s: tp.Optional[float] = None):
    """Collapse repeats, drop blanks: (T, V) -> (ids, [(begin, end)]) with the
    spans in frames, or in seconds when ``hop_s`` is given."""
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().float().cpu().numpy()
    ids = np.argmax(np.asarray(logits), axis=-1)
    out, spans = [], []
    prev, start = blank_id, 0
    for t, i in enumerate(ids):
        if i != prev and prev != blank_id:
            out.append(int(prev))
            spans.append((start, t))
        if i != prev:
            start = t
        prev = i
    if prev != blank_id:
        out.append(int(prev))
        spans.append((start, len(ids)))
    if hop_s is not None:
        spans = [(b * hop_s, e * hop_s) for b, e in spans]
    return np.asarray(out, np.int32), spans
