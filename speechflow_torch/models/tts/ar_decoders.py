"""Autoregressive decoders (counterpart of
``speechflow_tpu/models/tts/ar_decoders.py``): the Tacotron2 decoder and the
XTTS family.

- ``TacoDecoder`` with ``LSAttention``: a GRU cell (flax's, ``layers.RNN``'s
  cell) steps over the frames on prenet(previous frame) and the attention
  context; location-sensitive attention scores the memory from the query, the
  memory and a conv over the previous and cumulative attention weights. The
  training call is teacher-forced (a zero go frame, then the targets), with the
  prenet's dropout masks drawn for every step up front (or given, as a test
  gives JAX's); ``generate`` feeds its frames back for ``max_frames`` steps
  and returns the gate logits for the caller to trim.

- ``CausalBlock``: pre-norm causal self-attention with explicit q/k/v
  projections. RoPE rotates the normed full-width input, and q, k and v are
  all projected from the rotated input, as the JAX block does. Masked scores
  are -1e9 before a f32 softmax. Plain torch ops: the JAX package runs this
  attention outside any Pallas kernel.
- ``RetentionBlock``: multi-scale retention (RetNet), parallel over a prefix
  and recurrent, O(1) a token, when decoding.
- ``GPTDecoder``: a causal LM over [text ; (BOA ; audio prompt) ; BOS ;
  acoustic codes]. ``generate`` prefills the per-layer caches with one
  parallel pass, then decodes one token per step for exactly ``max_tokens``
  steps, as JAX's ``lax.scan`` does (no stop at EOS). The caches are
  preallocated at ``t_prefix + max_tokens`` and written in place.

Sampling: temperature 0 is argmax; above 0 it is
argmax(logits / temperature + Gumbel noise), which is what
``jax.random.categorical`` computes. The noise is drawn from a
``torch.Generator``, or given as ``gumbel`` draws (one (B, V) draw a token),
so that a test can feed the JAX package's own draws.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.models.layers import Conv1d, RNNCell, layer_norm
from speechflow_torch.models.tts.common import gelu, rope_rotate
from speechflow_torch.parallel.distributed import global_count
from speechflow_torch.utils.masks import sequence_mask

__all__ = ["LSAttention", "TacoDecoder", "CausalBlock", "RetentionBlock", "GPTDecoder"]

_MASKED = -1e9  # the JAX block's masked score


def _causal(t: int, device) -> torch.Tensor:
    return torch.tril(torch.ones(t, t, dtype=torch.bool, device=device))[None, None]


def _at(pos: int, positions: tp.Optional[torch.Tensor], device) -> torch.Tensor:
    """The (1,) position of a decode step: ``positions`` if given, else ``pos``
    copied from the host."""
    if positions is not None:
        return positions
    return torch.tensor([pos], dtype=torch.float32, device=device)


class LSAttention(nn.Module):
    """Location-sensitive attention."""

    def __init__(self, query_dim: int, memory_dim: int, attn_dim: int = 128,
                 n_filters: int = 32, kernel_size: int = 31):
        super().__init__()
        self.query_proj = nn.Linear(query_dim, attn_dim, bias=False)
        self.memory_proj = nn.Linear(memory_dim, attn_dim, bias=False)
        self.loc_conv = Conv1d(2, n_filters, kernel_size, bias=False)
        self.loc_proj = nn.Linear(n_filters, attn_dim, bias=False)
        self.v = nn.Linear(attn_dim, 1, bias=False)

    def forward(self, query, memory_proj, memory, attn_state, mask):
        """query (B, Dq); attn_state (B, N, 2) = [previous, cumulative] weights;
        returns (context (B, Dm), weights (B, N))."""
        loc = self.loc_proj(self.loc_conv(attn_state))
        e = self.v(torch.tanh(self.query_proj(query)[:, None] + memory_proj + loc))[..., 0]
        attn = torch.softmax(torch.where(mask, e, torch.full_like(e, _MASKED)), dim=-1)
        return torch.einsum("bn,bnd->bd", attn, memory), attn


def _gru_step(cell: RNNCell, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``nnx.GRUCell``: n = tanh(W_in·x + b_in + r ⊙ W_hn·h)."""
    xr, xz, xn = cell.dense_i(x).chunk(3, dim=-1)
    hr, hz, hn = cell.dense_h(h).chunk(3, dim=-1)
    r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
    return (1.0 - z) * torch.tanh(xn + r * hn) + z * h


class TacoDecoder(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dim: int = 512, prenet_dim: int = 256,
                 attn_dim: int = 128, prenet_dropout: float = 0.5, **kw):
        super().__init__()
        self.pre1 = nn.Linear(dim_out, prenet_dim)
        self.pre2 = nn.Linear(prenet_dim, prenet_dim)
        self.prenet_dropout = prenet_dropout
        self.attn = LSAttention(dim, dim_in, attn_dim)
        self.cell = RNNCell("gru", prenet_dim + dim_in, dim)
        self.frame_proj = nn.Linear(dim + dim_in, dim_out)
        self.gate_proj = nn.Linear(dim + dim_in, 1)
        self.dim = dim
        self.prenet_dim = prenet_dim
        self.dim_out = dim_out

    def drop_masks(self, t: int, b: int, deterministic: bool, device=None,
                   generator: tp.Optional[torch.Generator] = None
                   ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """The prenet's two (t, b, prenet_dim) dropout masks (keep / keep, or 0)."""
        if deterministic or self.prenet_dropout <= 0:
            ones = torch.ones(t, b, self.prenet_dim, device=device)
            return ones, ones
        keep = 1.0 - self.prenet_dropout
        return tuple((torch.rand(t, b, self.prenet_dim, generator=generator,
                                 device=device) < keep).float() / keep for _ in range(2))

    def _steps(self, memory, memory_lengths, t: int, frames_in, masks):
        b, n, _ = memory.shape
        mask = sequence_mask(memory_lengths, n)
        memory_proj = self.attn.memory_proj(memory)
        h = memory.new_zeros(b, self.dim)
        state = memory.new_zeros(b, n, 2)
        state[:, 0, 0] = 1.0
        prev = memory.new_zeros(b, self.dim_out)
        frames, gates, attns = [], [], []
        for i in range(t):
            x = frames_in[:, i] if frames_in is not None else prev
            pre = torch.relu(self.pre2(torch.relu(self.pre1(x)) * masks[0][i].to(x.dtype)))
            pre = pre * masks[1][i].to(x.dtype)
            context, attn = self.attn(h, memory_proj, memory, state, mask)
            h = _gru_step(self.cell, h, torch.cat([pre, context.to(pre.dtype)], dim=-1))
            hc = torch.cat([h, context.to(h.dtype)], dim=-1)
            prev = self.frame_proj(hc)
            frames.append(prev)
            gates.append(self.gate_proj(hc)[..., 0])
            attns.append(attn)
            state = torch.stack([attn, state[..., 1] + attn], dim=-1).to(state.dtype)
        return torch.stack(frames, 1), torch.stack(gates, 1), torch.stack(attns, 1)

    def forward(self, memory: torch.Tensor, memory_lengths: torch.Tensor,
                target_frames: torch.Tensor, deterministic: bool = True,
                masks: tp.Optional[tp.Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: tp.Optional[torch.Generator] = None):
        """Teacher-forced: (frames (B, T, dim_out), gate logits (B, T), attention
        (B, T, N)) from the go frame and the targets shifted by one."""
        b, t = target_frames.shape[:2]
        target_frames = target_frames.to(memory.dtype)
        frames_in = torch.cat([torch.zeros_like(target_frames[:, :1]),
                               target_frames[:, :-1]], dim=1)
        if masks is None:
            masks = self.drop_masks(t, b, deterministic, memory.device, generator)
        return self._steps(memory, memory_lengths, t, frames_in, masks)

    def generate(self, memory: torch.Tensor, memory_lengths: torch.Tensor,
                 max_frames: int = 1024):
        """Feedback decoding for ``max_frames`` steps: (frames, gate logits)."""
        b = memory.shape[0]
        ones = self.drop_masks(max_frames, b, True, memory.device)
        frames, gates, _ = self._steps(memory, memory_lengths, max_frames, None, ones)
        return frames, gates


class CausalBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.head_dim = dim // n_heads
        self.norm1 = layer_norm(dim)
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)
        self.norm2 = layer_norm(dim)
        self.ff1 = nn.Linear(dim, 4 * dim)
        self.ff2 = nn.Linear(4 * dim, dim)

    def _qkv(self, x: torch.Tensor, positions: tp.Optional[torch.Tensor] = None):
        b, t, _ = x.shape
        h = rope_rotate(self.norm1(x), positions=positions)
        shape = (b, t, self.n_heads, self.head_dim)
        return self.q(h).view(shape), self.k(h).view(shape), self.v(h).view(shape)

    def _attend(self, q, k, v, mask: tp.Optional[torch.Tensor]) -> torch.Tensor:
        """q (B, t, H, dh) over k, v (B, s, H, dh); mask broadcasts to (B, H, t, s),
        None attends to every key."""
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.head_dim)
        if mask is not None:
            scores = scores.masked_fill(~mask, _MASKED)
        attn = torch.softmax(scores.float(), dim=-1)
        b, t = q.shape[:2]
        return torch.einsum("bhqk,bkhd->bqhd", attn.to(v.dtype), v).reshape(b, t, -1)

    def _ff(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ff2(gelu(self.ff1(self.norm2(x))))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (B, t, D); mask (B|1, 1, t, t) bool."""
        q, k, v = self._qkv(x)
        return self._ff(x + self.o(self._attend(q, k, v, mask)))

    # -- KV-cached decoding --------------------------------------------------

    def init_cache(self, b: int, max_len: int, dtype=torch.float32, device=None):
        shape = (b, max_len, self.n_heads, self.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def prefill(self, x: torch.Tensor, cache, valid: tp.Optional[torch.Tensor] = None):
        """Causal pass over the prefix x (B, t, D); writes cache[:, :t] in place.
        ``valid`` (B, >= t) masks padded prefix keys."""
        t = x.shape[1]
        q, k, v = self._qkv(x)
        cache[0][:, :t] = k
        cache[1][:, :t] = v
        mask = _causal(t, x.device)
        if valid is not None:
            mask = mask & valid[:, None, None, :t]
        return self._ff(x + self.o(self._attend(q, k, v, mask))), cache

    def decode_step(self, x_t: torch.Tensor, cache, pos: int,
                    valid: tp.Optional[torch.Tensor] = None,
                    positions: tp.Optional[torch.Tensor] = None):
        """One token x_t (B, 1, D) at absolute position ``pos``; writes the
        cache at ``pos`` in place. Keys past ``pos`` are masked in the JAX block;
        they are left out here, which gives the same weights (theirs are exactly
        0 after the softmax) and reads only the written part of the cache.
        ``positions``: ``pos`` as a (1,) tensor on x_t's device, which a decode
        loop slices from one arange so that no step copies from the host."""
        q, k, v = self._qkv(x_t, positions=_at(pos, positions, x_t.device))
        cache[0][:, pos] = k[:, 0]
        cache[1][:, pos] = v[:, 0]
        mask = None if valid is None else valid[:, None, None, :pos + 1]
        o = self._attend(q, cache[0][:, :pos + 1], cache[1][:, :pos + 1], mask)
        return self._ff(x_t + self.o(o)), cache


class RetentionBlock(nn.Module):
    """Parallel form: out_h = (Q Kᵀ ⊙ D_h) V / sqrt(dh), D_h[n, m] = γ_h^(n-m)
    for n >= m, γ_h = 1 - 2^(-5-h); a key mask multiplies the scores. RoPE
    rotates the full-width q and k projections before the heads split. The
    heads' output is group-normed per token ((B·T, D), a group a head, eps
    1e-6) and gated by silu(g(h))."""

    def __init__(self, dim: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.head_dim = dim // n_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.g = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.norm = layer_norm(dim)
        self.gnorm = nn.GroupNorm(n_heads, dim, eps=1e-6)
        self.ff1 = nn.Linear(dim, 4 * dim)
        self.ff2 = nn.Linear(4 * dim, dim)
        self.norm2 = layer_norm(dim)
        self.gammas = tuple(1.0 - 2.0 ** (-5.0 - h) for h in range(n_heads))
        self._gamma_on: tp.Dict[torch.device, torch.Tensor] = {}

    def _gammas(self, device) -> torch.Tensor:
        """γ (H,) f32 on ``device``, copied from the host once a device."""
        device = torch.device(device)
        if device not in self._gamma_on:
            self._gamma_on[device] = torch.tensor(self.gammas, dtype=torch.float32,
                                                  device=device)
        return self._gamma_on[device]

    def _qkv(self, x: torch.Tensor, positions: tp.Optional[torch.Tensor] = None):
        b, t, _ = x.shape
        h = self.norm(x)
        shape = (b, t, self.n_heads, self.head_dim)
        q = rope_rotate(self.q(h), positions=positions).view(shape)
        k = rope_rotate(self.k(h), positions=positions).view(shape)
        return h, q, k, self.v(h).view(shape)

    def _mix(self, x: torch.Tensor, h: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        b, t = x.shape[:2]
        o = self.gnorm(o.reshape(b * t, -1)).view(b, t, -1)
        x = x + self.out(o * F.silu(self.g(h)))
        return x + self.ff2(gelu(self.ff1(self.norm2(x))))

    def forward(self, x: torch.Tensor, mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, t, D); mask (B|1, 1, t, t) bool or None (causality lives in
        the decay)."""
        return self._parallel(x, *self._qkv(x), mask)

    def _parallel(self, x, h, q, k, v, mask: tp.Optional[torch.Tensor]) -> torch.Tensor:
        t = x.shape[1]
        n = torch.arange(t, device=x.device)
        rel = (n[:, None] - n[None, :]).float()
        g = self._gammas(x.device)[:, None, None]
        decay = torch.where(rel >= 0, g ** rel.clamp(min=0), torch.zeros((), device=x.device))
        scores = torch.einsum("bthd,bshd->bhts", q, k) * decay.to(q.dtype) / math.sqrt(
            self.head_dim)
        if mask is not None:
            scores = scores * mask.to(scores.dtype)
        return self._mix(x, h, torch.einsum("bhts,bshd->bthd", scores, v))

    # -- recurrent decoding ----------------------------------------------------

    def init_cache(self, b: int, max_len: int, dtype=torch.float32, device=None):
        return torch.zeros(b, self.n_heads, self.head_dim, self.head_dim, dtype=dtype,
                           device=device)

    def prefill(self, x: torch.Tensor, cache, valid: tp.Optional[torch.Tensor] = None):
        """The parallel pass over the prefix and the recurrent state
        S = Σ_m γ^(t-1-m) k_m ⊗ v_m; ``valid`` (B, >= t) drops padded prefix
        positions from the state and from the scores."""
        t = x.shape[1]
        h, q, k, v = self._qkv(x)
        k_state = k if valid is None else k * valid[:, :t, None, None].to(k.dtype)
        w = self._gammas(x.device)[:, None] ** (
            t - 1 - torch.arange(t, device=x.device)).float()[None, :]
        state = torch.einsum("ht,bthd,bthe->bhde", w.to(k.dtype), k_state, v)
        mask = None
        if valid is not None:
            mask = _causal(t, x.device) & valid[:, None, None, :t]
        return self._parallel(x, h, q, k, v, mask), state.to(cache.dtype)

    def decode_step(self, x_t: torch.Tensor, cache, pos: int,
                    valid: tp.Optional[torch.Tensor] = None,
                    positions: tp.Optional[torch.Tensor] = None):
        """One token: S <- γ·S + k ⊗ v; out = q S / sqrt(dh). ``positions`` as
        ``CausalBlock.decode_step``'s."""
        h, q, k, v = self._qkv(x_t, positions=_at(pos, positions, x_t.device))
        state = cache * self._gammas(x_t.device)[None, :, None, None].to(cache.dtype) + \
            torch.einsum("bhd,bhe->bhde", k[:, 0], v[:, 0])
        o = torch.einsum("bhd,bhde->bhe", q[:, 0], state)[:, None] / math.sqrt(self.head_dim)
        return self._mix(x_t, h, o), state


class GPTDecoder(nn.Module):
    """Causal LM over [text ; (BOA ; prompt) ; BOS ; codes]; the prompt (already
    encoded to model-width frames) sits behind a learned BOA token
    (``boa_tok``, N(0, 0.02) as JAX's) when ``use_prompt``."""

    def __init__(self, n_text_tokens: int = 256, n_audio_tokens: int = 1026,
                 dim: int = 512, n_layers: int = 8, n_heads: int = 8,
                 cond_dim: tp.Optional[int] = None, block_type: str = "attention",
                 use_prompt: bool = False):
        super().__init__()
        self.text_emb = nn.Embedding(n_text_tokens, dim)
        self.audio_emb = nn.Embedding(n_audio_tokens, dim)
        block = RetentionBlock if block_type == "retention" else CausalBlock
        self.blocks = nn.ModuleList(block(dim, n_heads) for _ in range(n_layers))
        self.norm = layer_norm(dim)
        self.head = nn.Linear(dim, n_audio_tokens)
        self.cond_proj = nn.Linear(cond_dim, dim) if cond_dim else None
        self.boa_tok = nn.Parameter(torch.randn(1, 1, dim) * 0.02) if use_prompt else None
        self.n_audio_tokens = n_audio_tokens
        self.bos = n_audio_tokens - 2
        self.eos = n_audio_tokens - 1

    def _prefix(self, text_ids: torch.Tensor, prompt_emb=None, prompt_lengths=None):
        """[text ; BOA ; prompt] embeddings and the validity of each key (B, L)."""
        t_emb = self.text_emb(text_ids)
        b, t_text = text_ids.shape
        dev = t_emb.device
        parts, valids = [t_emb], [torch.ones(b, t_text, dtype=torch.bool, device=dev)]
        if prompt_emb is not None:
            if self.boa_tok is None:
                raise ValueError("GPTDecoder built without use_prompt=True")
            parts += [self.boa_tok.expand(b, 1, t_emb.shape[-1]), prompt_emb.to(t_emb.dtype)]
            pv = (sequence_mask(prompt_lengths.to(dev), prompt_emb.shape[1])
                  if prompt_lengths is not None
                  else torch.ones(b, prompt_emb.shape[1], dtype=torch.bool, device=dev))
            valids += [torch.ones(b, 1, dtype=torch.bool, device=dev), pv]
        return torch.cat(parts, dim=1), torch.cat(valids, dim=1)

    def _cond_emb(self, cond: tp.Optional[torch.Tensor]) -> tp.Optional[torch.Tensor]:
        if self.cond_proj is None or cond is None:
            return None
        return self.cond_proj(cond)[:, None, :]

    def _trunk(self, text_ids, audio_ids, cond=None, prompt_emb=None, prompt_lengths=None):
        prefix, pvalid = self._prefix(text_ids, prompt_emb, prompt_lengths)
        a_emb = self.audio_emb(audio_ids)
        x = torch.cat([prefix, a_emb], dim=1)
        cond_emb = self._cond_emb(cond)
        if cond_emb is not None:
            x = x + cond_emb
        mask = _causal(x.shape[1], x.device)
        if prompt_emb is not None and prompt_lengths is not None:
            valid = torch.cat([pvalid, torch.ones(x.shape[0], a_emb.shape[1], dtype=torch.bool,
                                                  device=x.device)], dim=1)
            mask = mask & valid[:, None, None, :]
        for blk in self.blocks:
            x = blk(x, mask)
        return self.head(self.norm(x))

    def forward(self, text_ids, audio_ids, cond=None, prompt_emb=None, prompt_lengths=None):
        """Teacher-forced logits (B, T_audio, V): audio_ids[t] predicted from
        [text ; (BOA ; prompt) ; BOS ; audio_ids[:t]]."""
        bos = torch.full((audio_ids.shape[0], 1), self.bos, dtype=audio_ids.dtype,
                         device=audio_ids.device)
        inputs = torch.cat([bos, audio_ids[:, :-1]], dim=1)
        logits = self._trunk(text_ids, inputs, cond, prompt_emb, prompt_lengths)
        return logits[:, -audio_ids.shape[1]:]

    def loss(self, text_ids, audio_ids, audio_lengths, cond=None, prompt_emb=None,
             prompt_lengths=None) -> torch.Tensor:
        """Cross-entropy over the valid audio positions."""
        logits = self(text_ids, audio_ids, cond, prompt_emb, prompt_lengths).float()
        ce = F.cross_entropy(logits.transpose(1, 2), audio_ids.long(), reduction="none")
        mask = sequence_mask(audio_lengths.to(ce.device), audio_ids.shape[1]).to(ce.dtype)
        return (ce * mask).sum() / global_count(mask.sum()).clamp(min=1.0)

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                generator: tp.Optional[torch.Generator] = None,
                gumbel: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, V) -> (B,) int64: argmax at temperature 0, else
        argmax(logits / temperature + g), g Gumbel noise (``gumbel``, else drawn
        from ``generator``)."""
        if temperature <= 0:
            return logits.argmax(-1)
        scaled = logits.float() / temperature
        if gumbel is None:
            u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
            gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
        return (scaled + gumbel.to(scaled.device, torch.float32)).argmax(-1)

    def _draw(self, gumbel, i: int):
        return None if gumbel is None else gumbel[i]

    @torch.no_grad()
    def generate(self, text_ids: torch.Tensor, max_tokens: int = 256,
                 temperature: float = 0.8, generator: tp.Optional[torch.Generator] = None,
                 cond=None, prompt_emb=None, prompt_lengths=None,
                 gumbel: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """KV-cached sampling of ``max_tokens`` codes (B, max_tokens) int64.
        ``gumbel`` (max_tokens, B, V): the noise of each token, in place of draws
        from ``generator``."""
        b = text_ids.shape[0]
        cond_emb = self._cond_emb(cond)
        prefix, pvalid = self._prefix(text_ids, prompt_emb, prompt_lengths)
        bos = torch.full((b, 1), self.bos, dtype=torch.long, device=prefix.device)
        x = torch.cat([prefix, self.audio_emb(bos)], dim=1)
        if cond_emb is not None:
            x = x + cond_emb
        t_prefix = x.shape[1]  # text + (1 + prompt) + BOS
        l_max = t_prefix + max_tokens
        valid = None
        if prompt_emb is not None and prompt_lengths is not None:
            valid = torch.cat([pvalid, torch.ones(b, 1 + max_tokens, dtype=torch.bool,
                                                  device=x.device)], dim=1)
        caches = []
        for blk in self.blocks:
            x, cache = blk.prefill(x, blk.init_cache(b, l_max, x.dtype, x.device), valid)
            caches.append(cache)
        positions = torch.arange(l_max, dtype=torch.float32, device=x.device)
        tokens = torch.full((b, max_tokens), self.eos, dtype=torch.long, device=x.device)
        prev = self._sample(self.head(self.norm(x[:, -1])), temperature, generator,
                            self._draw(gumbel, 0))
        tokens[:, 0] = prev
        for i in range(1, max_tokens):
            x = self.audio_emb(prev[:, None])
            if cond_emb is not None:
                x = x + cond_emb
            pos = t_prefix - 1 + i  # audio token i-1 sits at t_prefix + i - 1
            for j, blk in enumerate(self.blocks):
                x, caches[j] = blk.decode_step(x, caches[j], pos, valid,
                                               positions[pos:pos + 1])
            prev = self._sample(self.head(self.norm(x[:, 0])), temperature, generator,
                                self._draw(gumbel, i))
            tokens[:, i] = prev
        return tokens

    @torch.no_grad()
    def generate_naive(self, text_ids: torch.Tensor, max_tokens: int = 256,
                       temperature: float = 0.8,
                       generator: tp.Optional[torch.Generator] = None, cond=None,
                       prompt_emb=None, prompt_lengths=None,
                       gumbel: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """O(T²) sampling that reruns the whole trunk each step: the reference
        of ``generate``."""
        b = text_ids.shape[0]
        tokens = torch.full((b, max_tokens), self.eos, dtype=torch.long,
                            device=text_ids.device)
        bos = torch.full((b, 1), self.bos, dtype=torch.long, device=text_ids.device)
        for i in range(max_tokens):
            inputs = torch.cat([bos, tokens[:, :-1]], dim=1)
            logits = self._trunk(text_ids, inputs, cond, prompt_emb,
                                 prompt_lengths)[:, -max_tokens:]
            tokens[:, i] = self._sample(logits[:, i], temperature, generator,
                                        self._draw(gumbel, i))
        return tokens
