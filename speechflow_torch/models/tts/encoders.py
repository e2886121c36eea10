"""The encoder zoo (counterpart of ``speechflow_tpu/models/tts/encoders.py``),
registered in ``TTS_ENCODERS`` under JAX's twelve names.

Each encoder maps (B, N, dim_in) content with lengths to (B, N, dim_out) and
takes the keyword arguments the JAX one takes (the rest fall into ``**kw``, as
in JAX: ``RNNEncoder`` builds one bi-GRU layer whatever ``n_layers`` says, and
``VQEncoder`` keeps its CNN's default dropout). Where the JAX encoder calls
flax's own attention (the conformer), the port calls ``MultiHeadAttention``
(``flash_attention_fn``), which differs only on padded query rows, which the
block masks before its convolution. ``VQEncoder`` keeps its auxiliary outputs
for ``pop_aux``; ``ContextEncoder`` with ``concat=False`` returns a list of
content streams for the variance adaptor's per-stream routing.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from speechflow_torch.models.layers import RNN, Conv1d, MultiHeadAttention, layer_norm
from speechflow_torch.models.tts.common import (
    ConditionalLayer,
    ConvStack,
    DiTBlock,
    TransformerBlock,
    VarianceEmbedding,
    VectorQuantizer,
    dropout,
    grad_reverse,
)
from speechflow_torch.utils.masks import apply_mask, sequence_mask

__all__ = ["TransformerEncoder", "DiTEncoder", "DummyEncoder", "CNNEncoder", "RNNEncoder",
           "VQEncoder", "ContextEncoder", "CBHGEncoder", "ConformerBlock", "ConformerEncoder",
           "VarianceEncoder", "SFEncoder", "LinguisticConditionEncoder", "TTS_ENCODERS"]

Tensor = tp.Optional[torch.Tensor]


def _mask(lengths: Tensor, t: int) -> Tensor:
    return sequence_mask(lengths, t) if lengths is not None else None


def _masked(x: torch.Tensor, mask: Tensor) -> torch.Tensor:
    return apply_mask(x, mask) if mask is not None else x


def _blocks(blocks: nn.ModuleList, x: torch.Tensor, mask: Tensor, deterministic: bool,
            remat: bool) -> torch.Tensor:
    """The blocks in order; ``remat`` recomputes each one's activations in the
    backward (``use_remat``, JAX's ``nnx.remat``)."""
    for blk in blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(blk, x, mask, deterministic, use_reentrant=False)
        else:
            x = blk(x, mask, deterministic)
    return x


class TransformerEncoder(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dim: int = 256, n_layers: int = 4,
                 n_heads: int = 4, dropout: float = 0.1, use_remat: bool = False, **kw):
        super().__init__()
        self.pre = nn.Linear(dim_in, dim) if dim_in != dim else None
        self.blocks = nn.ModuleList(TransformerBlock(dim, n_heads, dropout=dropout)
                                    for _ in range(n_layers))
        self.post = nn.Linear(dim, dim_out) if dim != dim_out else None
        self.dim_out = dim_out
        self.use_remat = use_remat

    def forward(self, x: torch.Tensor, lengths: Tensor = None, cond: Tensor = None,
                deterministic: bool = True) -> torch.Tensor:
        if self.pre is not None:
            x = self.pre(x)
        mask = _mask(lengths, x.shape[1])
        x = _blocks(self.blocks, x, mask, deterministic, self.use_remat)
        if self.post is not None:
            x = self.post(x)
        return _masked(x, mask)


class DiTEncoder(nn.Module):
    """AdaNorm-conditioned transformer (the CFM estimator's backbone)."""

    def __init__(self, dim_in: int, dim_out: int, dim: int = 256, n_layers: int = 4,
                 n_heads: int = 4, cond_dim: int = 256, dropout: float = 0.0, **kw):
        super().__init__()
        self.pre = nn.Linear(dim_in, dim) if dim_in != dim else None
        self.blocks = nn.ModuleList(DiTBlock(dim, cond_dim, n_heads, dropout=dropout)
                                    for _ in range(n_layers))
        self.post = nn.Linear(dim, dim_out) if dim != dim_out else None
        self.dim_out = dim_out
        self.cond_dim = cond_dim

    def forward(self, x: torch.Tensor, lengths: Tensor = None, cond: Tensor = None,
                deterministic: bool = True) -> torch.Tensor:
        if self.pre is not None:
            x = self.pre(x)
        if cond is None:
            cond = x.new_zeros(x.shape[0], self.cond_dim)
        mask = _mask(lengths, x.shape[1])
        for blk in self.blocks:
            x = blk(x, cond, mask, deterministic)
        if self.post is not None:
            x = self.post(x)
        return _masked(x, mask)


class DummyEncoder(nn.Module):
    """The identity, or one projection when the widths differ (no mask)."""

    def __init__(self, dim_in: int, dim_out: int, **kw):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out) if dim_in != dim_out else None
        self.dim_out = dim_out

    def forward(self, x: torch.Tensor, lengths: Tensor = None, cond: Tensor = None,
                deterministic: bool = True) -> torch.Tensor:
        return self.proj(x) if self.proj is not None else x


class CNNEncoder(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dim: int = 256, n_layers: int = 3,
                 kernel_size: int = 5, dropout: float = 0.1, **kw):
        super().__init__()
        self.stack = ConvStack(dim_in, dim, dim_out, n_layers, kernel_size, dropout)
        self.dim_out = dim_out

    def forward(self, x: torch.Tensor, lengths: Tensor = None, cond: Tensor = None,
                deterministic: bool = True) -> torch.Tensor:
        if lengths is not None:
            x = apply_mask(x, sequence_mask(lengths, x.shape[1]))
        return self.stack(x, deterministic)


class RNNEncoder(nn.Module):
    """A bidirectional GRU of one layer: dim_out // 2 forward and the rest
    backward (two modules, so an odd width splits as JAX splits it). The
    backward GRU starts from the padded tail, as JAX's (no ``seq_lengths``).
    ``dim`` is the inner width that the builders pass every registered encoder;
    a one-layer bi-GRU has none, so it takes it and uses none, as JAX's does."""

    def __init__(self, dim_in: int, dim_out: int, dim: int = 256, **kw):
        super().__init__()
        half = dim_out // 2
        self.fwd = RNN("gru", dim_in, half)
        self.bwd = RNN("gru", dim_in, dim_out - half, reverse=True)
        self.dim_out = dim_out

    def forward(self, x: torch.Tensor, lengths: Tensor = None, cond: Tensor = None,
                deterministic: bool = True) -> torch.Tensor:
        out = torch.cat([self.fwd(x), self.bwd(x)], dim=-1).to(x.dtype)
        return _masked(out, _mask(lengths, x.shape[1]))


class VQEncoder(nn.Module):
    """A CNN encoder (its default dropout), a VQ bottleneck and, with
    ``n_speakers``, a speaker classifier behind a gradient reversal. ``pop_aux``
    returns the last call's ``vq_loss``, ``vq_codes`` and
    ``inverse_speaker_logits``."""

    def __init__(self, dim_in: int, dim_out: int, dim: int = 256, n_layers: int = 3,
                 codebook_size: int = 256, n_speakers: tp.Optional[int] = None, **kw):
        super().__init__()
        self.enc = CNNEncoder(dim_in, dim_out, dim, n_layers)
        self.vq = VectorQuantizer(codebook_size, dim_out)
        self.clf = nn.Linear(dim_out, n_speakers) if n_speakers else None
        self.dim_out = dim_out
        self._aux: tp.Dict[str, torch.Tensor] = {}

    def forward(self, x: torch.Tensor, lengths: Tensor = None, cond: Tensor = None,
                deterministic: bool = True) -> torch.Tensor:
        h = self.enc(x, lengths, deterministic=deterministic)
        q, idx, vq_loss = self.vq(h)
        aux = {"vq_loss": vq_loss, "vq_codes": idx}
        if self.clf is not None:
            aux["inverse_speaker_logits"] = self.clf(grad_reverse(q).mean(dim=1))
        self._aux = aux
        return q

    def pop_aux(self) -> tp.Dict[str, torch.Tensor]:
        aux, self._aux = self._aux, {}
        return aux


class ContextEncoder(nn.Module):
    """Sub-encoders (built with their defaults) over the same content, dim_out
    split among them; their outputs concatenated, or with ``concat=False`` a
    list of streams (``dim_out`` is then the list of their widths)."""

    def __init__(self, dim_in: int, dim_out: int,
                 sub_types: tp.Sequence[str] = ("cnn", "transformer"), dim: int = 256,
                 concat: bool = True, **kw):
        super().__init__()
        per = dim_out // len(sub_types)
        dims = [per] * (len(sub_types) - 1) + [dim_out - per * (len(sub_types) - 1)]
        self.subs = nn.ModuleList(TTS_ENCODERS[t](dim_in=dim_in, dim_out=d, dim=dim)
                                  for t, d in zip(sub_types, dims))
        self.concat = concat
        self.stream_dims = dims
        self.dim_out = dim_out if concat else dims

    def forward(self, x: torch.Tensor, lengths: Tensor = None, cond: Tensor = None,
                deterministic: bool = True):
        outs = [s(x, lengths, cond, deterministic=deterministic) for s in self.subs]
        return torch.cat(outs, dim=-1) if self.concat else outs


class _Highway(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.h = nn.Linear(dim, dim)
        self.t = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.t(x))
        return gate * F.relu(self.h(x)) + (1.0 - gate) * x


class CBHGEncoder(nn.Module):
    """Conv bank (kernels 1..n_banks) over a projection, LayerNorm, stride-1 max
    pool of width 2, two conv projections with a residual, highways, a
    projection."""

    def __init__(self, dim_in: int, dim_out: int, dim: int = 256, n_banks: int = 8,
                 n_highways: int = 4, kernel_size: int = 3, dropout: float = 0.1, **kw):
        super().__init__()
        self.pre = nn.Linear(dim_in, dim)
        self.bank = nn.ModuleList(Conv1d(dim, dim, k, bias=False) for k in range(1, n_banks + 1))
        self.bank_norm = layer_norm(n_banks * dim)
        self.proj1 = Conv1d(n_banks * dim, dim, kernel_size, bias=False)
        self.norm1 = layer_norm(dim)
        self.proj2 = Conv1d(dim, dim, kernel_size, bias=False)
        self.norm2 = layer_norm(dim)
        self.highways = nn.ModuleList(_Highway(dim) for _ in range(n_highways))
        self.post = nn.Linear(dim, dim_out)
        self.dropout = dropout
        self.dim_out = dim_out

    def forward(self, x: torch.Tensor, lengths: Tensor = None, cond: Tensor = None,
                deterministic: bool = True) -> torch.Tensor:
        mask = _mask(lengths, x.shape[1])
        x = _masked(self.pre(x), mask)
        h = self.bank_norm(torch.cat([F.relu(conv(x)) for conv in self.bank], dim=-1))
        h = torch.maximum(h, F.pad(h, (0, 0, 0, 1), value=-1e9)[:, 1:])
        h = self.norm1(F.relu(self.proj1(h)))
        h = self.norm2(self.proj2(h))
        x = x + dropout(h, self.dropout, deterministic)
        for hw in self.highways:
            x = hw(x)
        return _masked(self.post(x), mask)


class ConformerBlock(nn.Module):
    """Macaron FF -> MHSA -> depthwise conv module -> FF, pre-LN, a final norm."""

    def __init__(self, dim: int, n_heads: int = 4, kernel_size: int = 7,
                 dropout: float = 0.1):
        super().__init__()
        self.ff1_norm = layer_norm(dim)
        self.ff1a = nn.Linear(dim, 4 * dim)
        self.ff1b = nn.Linear(4 * dim, dim)
        self.attn_norm = layer_norm(dim)
        self.attn = MultiHeadAttention(dim, n_heads, dropout)
        self.conv_norm = layer_norm(dim)
        self.pw1 = Conv1d(dim, 2 * dim, 1)
        self.dw = Conv1d(dim, dim, kernel_size, groups=dim)
        self.dw_norm = layer_norm(dim)
        self.pw2 = Conv1d(dim, dim, 1)
        self.ff2_norm = layer_norm(dim)
        self.ff2a = nn.Linear(dim, 4 * dim)
        self.ff2b = nn.Linear(4 * dim, dim)
        self.final_norm = layer_norm(dim)
        self.dropout = dropout

    def _ff(self, x, norm, a, b, deterministic):
        h = b(dropout(F.silu(a(norm(x))), self.dropout, deterministic))
        return dropout(h, self.dropout, deterministic)

    def forward(self, x: torch.Tensor, mask: Tensor = None,
                deterministic: bool = True) -> torch.Tensor:
        x = x + 0.5 * self._ff(x, self.ff1_norm, self.ff1a, self.ff1b, deterministic)
        x = x + dropout(self.attn(self.attn_norm(x), mask, deterministic), self.dropout,
                        deterministic)
        h = _masked(self.conv_norm(x), mask)
        h = F.glu(self.pw1(h), dim=-1)
        h = F.silu(self.dw_norm(self.dw(h)))
        x = x + dropout(self.pw2(h), self.dropout, deterministic)
        x = x + 0.5 * self._ff(x, self.ff2_norm, self.ff2a, self.ff2b, deterministic)
        return self.final_norm(x)


class ConformerEncoder(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dim: int = 256, n_layers: int = 4,
                 n_heads: int = 4, kernel_size: int = 7, dropout: float = 0.1,
                 use_remat: bool = False, **kw):
        super().__init__()
        self.pre = nn.Linear(dim_in, dim) if dim_in != dim else None
        self.blocks = nn.ModuleList(ConformerBlock(dim, n_heads, kernel_size, dropout)
                                    for _ in range(n_layers))
        self.post = nn.Linear(dim, dim_out) if dim != dim_out else None
        self.dim_out = dim_out
        self.use_remat = use_remat

    def forward(self, x: torch.Tensor, lengths: Tensor = None, cond: Tensor = None,
                deterministic: bool = True) -> torch.Tensor:
        if self.pre is not None:
            x = self.pre(x)
        mask = _mask(lengths, x.shape[1])
        x = _blocks(self.blocks, x, mask, deterministic, self.use_remat)
        if self.post is not None:
            x = self.post(x)
        return _masked(x, mask)


class VarianceEncoder(nn.Module):
    """Parallel convs (kernels ``kernel_sizes[:-1]``) fused by one more conv, a
    bidirectional LSTM over the masked result, a projection."""

    def __init__(self, dim_in: int, dim_out: int, dim: int = 256,
                 kernel_sizes: tp.Sequence[int] = (3, 7, 13, 3), use_rnn: bool = True,
                 dropout: float = 0.1, **kw):
        super().__init__()
        first, last = kernel_sizes[:-1], kernel_sizes[-1]
        self.first_convs = nn.ModuleList(Conv1d(dim_in, dim, k) for k in first)
        self.first_norms = nn.ModuleList(layer_norm(dim) for _ in first)
        self.second_conv = Conv1d(len(first) * dim, dim, last)
        self.second_norm = layer_norm(dim)
        self.use_rnn = use_rnn
        if use_rnn:
            half = dim // 2
            self.fwd = RNN("lstm", dim, half)
            self.bwd = RNN("lstm", dim, dim - half, reverse=True)
        self.post = nn.Linear(dim, dim_out)
        self.dropout = dropout
        self.dim_out = dim_out

    def forward(self, x: torch.Tensor, lengths: Tensor = None, cond: Tensor = None,
                deterministic: bool = True) -> torch.Tensor:
        mask = _mask(lengths, x.shape[1])
        hs = [dropout(norm(F.silu(conv(x))), self.dropout, deterministic)
              for conv, norm in zip(self.first_convs, self.first_norms)]
        h = dropout(self.second_norm(F.silu(self.second_conv(torch.cat(hs, dim=-1)))),
                    self.dropout, deterministic)
        if self.use_rnn:
            h = _masked(h, mask)
            h = torch.cat([self.fwd(h), self.bwd(h)], dim=-1).to(h.dtype)
        return _masked(self.post(h), mask)


class SFEncoder(nn.Module):
    """Source-filter: the content and the bucketed pitch and energy contours
    (keywords ``pitch``, ``energy``) each through a ``base`` encoder, summed,
    then a fusion encoder."""

    def __init__(self, dim_in: int, dim_out: int, dim: int = 256, base: str = "rnn",
                 pitch_interval: tp.Tuple[float, float] = (0.0, 880.0),
                 energy_interval: tp.Tuple[float, float] = (0.0, 150.0), emb_dim: int = 64,
                 **kw):
        super().__init__()
        self.pitch_emb = VarianceEmbedding(pitch_interval, 256, emb_dim, log_scale=True)
        self.energy_emb = VarianceEmbedding(energy_interval, 256, emb_dim)
        self.pre_source = nn.Linear(dim_in, dim)
        self.pre_pitch = nn.Linear(emb_dim, dim)
        self.pre_energy = nn.Linear(emb_dim, dim)
        enc = TTS_ENCODERS[base]
        self.source_enc = enc(dim_in=dim, dim_out=dim, dim=dim)
        self.filter_enc_p = enc(dim_in=dim, dim_out=dim, dim=dim)
        self.filter_enc_e = enc(dim_in=dim, dim_out=dim, dim=dim)
        self.fusion = enc(dim_in=dim, dim_out=dim_out, dim=dim)
        self.dim_out = dim_out

    def forward(self, x: torch.Tensor, lengths: Tensor = None, cond: Tensor = None,
                deterministic: bool = True, pitch: Tensor = None,
                energy: Tensor = None) -> torch.Tensor:
        h = self.source_enc(self.pre_source(x), lengths, cond, deterministic=deterministic)
        if pitch is not None:
            h = h + self.filter_enc_p(self.pre_pitch(self.pitch_emb(pitch).to(h.dtype)),
                                      lengths, cond, deterministic=deterministic)
        if energy is not None:
            h = h + self.filter_enc_e(self.pre_energy(self.energy_emb(energy).to(h.dtype)),
                                      lengths, cond, deterministic=deterministic)
        return self.fusion(h, lengths, cond, deterministic=deterministic)


class LinguisticConditionEncoder(nn.Module):
    """The content conditioned on the linguistic and LM features (keywords
    ``ling_feat``, ``lm_feat``) by ``ConditionalLayer``s, then a ``base``
    encoder."""

    def __init__(self, dim_in: int, dim_out: int, dim: int = 256, base: str = "transformer",
                 method: str = "cat", ling_feat_dim: int = 56, lm_feat_dim: int = 32,
                 n_layers: int = 4, n_heads: int = 4, dropout: float = 0.1, **kw):
        super().__init__()
        self.ling_cond = ConditionalLayer(method, dim_in, ling_feat_dim)
        self.lm_cond = ConditionalLayer(method, dim_in, lm_feat_dim)
        self.base = TTS_ENCODERS[base](dim_in=dim_in, dim_out=dim_out, dim=dim,
                                       n_layers=n_layers, n_heads=n_heads, dropout=dropout)
        self.dim_out = dim_out

    def forward(self, x: torch.Tensor, lengths: Tensor = None, cond: Tensor = None,
                deterministic: bool = True, ling_feat: Tensor = None,
                lm_feat: Tensor = None) -> torch.Tensor:
        if ling_feat is not None:
            x = self.ling_cond(x, ling_feat.to(x.dtype))
        if lm_feat is not None:
            x = self.lm_cond(x, lm_feat.to(x.dtype))
        return self.base(x, lengths, cond, deterministic=deterministic)


TTS_ENCODERS: tp.Dict[str, type] = {
    "dummy": DummyEncoder,
    "cnn": CNNEncoder,
    "rnn": RNNEncoder,
    "transformer": TransformerEncoder,
    "dit": DiTEncoder,
    "vq": VQEncoder,
    "context": ContextEncoder,
    "cbhg": CBHGEncoder,
    "conformer": ConformerEncoder,
    "variance_encoder": VarianceEncoder,
    "sf": SFEncoder,
    "ling_condition": LinguisticConditionEncoder,
}
