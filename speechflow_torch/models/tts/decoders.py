"""Decoders (counterpart of ``speechflow_tpu/models/tts/decoders.py``):
``WrapperDecoder`` and the inference side of ``CFMDecoder``."""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.models.tts.common import sinusoidal_embedding
from speechflow_torch.models.tts.encoders import TTS_ENCODERS, DiTEncoder
from speechflow_torch.utils.masks import apply_mask, sequence_mask

__all__ = ["WrapperDecoder", "CFMDecoder", "TTS_DECODERS"]


class WrapperDecoder(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, inner: str = "transformer",
                 dim: int = 256, n_layers: int = 4, **kw):
        super().__init__()
        self.enc = TTS_ENCODERS[inner](dim_in=dim_in, dim_out=dim, dim=dim,
                                       n_layers=n_layers)
        self.out = nn.Linear(dim, dim_out)
        self.dim_out = dim_out

    def forward(self, x: torch.Tensor, lengths: tp.Optional[torch.Tensor] = None,
                cond: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.out(self.enc(x, lengths, cond))
        if lengths is not None:
            out = apply_mask(out, sequence_mask(lengths, out.shape[1]))
        return out


class CFMDecoder(nn.Module):
    """Conditional flow matching decoder: a prior projection gives mu, and a
    fixed-step Euler solve over the cosine time grid integrates the DiT
    estimator from the initial noise, with batched classifier-free guidance
    when ``cfg_scale > 0``."""

    def __init__(self, dim_in: int, dim_out: int, dim: int = 256, n_layers: int = 4,
                 n_heads: int = 4, cond_dim: int = 256, n_timesteps: int = 30,
                 temperature: float = 0.667, cfg_scale: float = 0.0, **kw):
        super().__init__()
        self.prior = nn.Linear(dim_in, dim_out)
        # estimator input: x_t ++ mu ++ content
        self.estimator = DiTEncoder(dim_in=2 * dim_out + dim_in, dim_out=dim_out,
                                    dim=dim, n_layers=n_layers, n_heads=n_heads,
                                    cond_dim=cond_dim + dim)
        self.time_mlp1 = nn.Linear(dim, dim)
        self.time_mlp2 = nn.Linear(dim, dim)
        self.fake_content = nn.Parameter(torch.zeros(dim_in))
        self.fake_condition = nn.Parameter(torch.zeros(cond_dim))
        self.n_timesteps = n_timesteps
        self.temperature = temperature
        self.cfg_scale = cfg_scale
        self.cond_dim = cond_dim
        self.dim = dim
        self.dim_out = dim_out

    def _time_emb(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        emb = sinusoidal_embedding(t * 1000.0, self.dim).to(dtype)
        return self.time_mlp2(F.silu(self.time_mlp1(emb)))

    def _dphi(self, x_t, mu, content, t, cond, lengths):
        c_full = torch.cat([cond, self._time_emb(t, x_t.dtype)], dim=-1)
        est_in = torch.cat([x_t, mu, content], dim=-1)
        return self.estimator(est_in, lengths, c_full)

    def generate(self, content: torch.Tensor, lengths: torch.Tensor,
                 cond: tp.Optional[torch.Tensor], noise: torch.Tensor,
                 n_timesteps: tp.Optional[int] = None
                 ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """Returns (mu, x_1). ``noise`` is the initial state x_0, already
        scaled by the temperature, shaped like mu (B, T, dim_out)."""
        mu = self.prior(content)
        if noise.shape != mu.shape:
            raise ValueError(f"noise {tuple(noise.shape)} != mu {tuple(mu.shape)}")
        n_steps = n_timesteps or self.n_timesteps
        s = torch.linspace(0.0, 1.0, n_steps + 1, dtype=torch.float32)
        ts = 1.0 - torch.cos(0.5 * math.pi * s)
        dts = ts[1:] - ts[:-1]
        b = mu.shape[0]
        if cond is None:
            cond = mu.new_zeros(b, self.cond_dim)

        if self.cfg_scale > 0:
            # batched CFG: one estimator call on the doubled batch per step
            content = torch.cat([content, self.fake_content.to(content.dtype)
                                 .expand_as(content)], dim=0)
            mu_in = torch.cat([mu, mu], dim=0)
            cond = torch.cat([cond, self.fake_condition.to(cond.dtype)
                              .expand_as(cond)], dim=0)
            lengths_in = torch.cat([lengths, lengths], dim=0)
        else:
            mu_in, lengths_in = mu, lengths

        x = noise.to(mu.dtype)
        for t, dt in zip(ts[:-1].tolist(), dts.tolist()):
            if self.cfg_scale > 0:
                tb = torch.full((2 * b,), t, dtype=torch.float32, device=mu.device)
                v2 = self._dphi(torch.cat([x, x], dim=0), mu_in, content, tb, cond,
                                lengths_in)
                v_c, v_un = v2[:b], v2[b:]
                v = v_c + self.cfg_scale * (v_c - v_un)
            else:
                tb = torch.full((b,), t, dtype=torch.float32, device=mu.device)
                v = self._dphi(x, mu_in, content, tb, cond, lengths_in)
            x = x + dt * v
        return mu, apply_mask(x, sequence_mask(lengths, x.shape[1]))


TTS_DECODERS: tp.Dict[str, type] = {
    "wrapper": WrapperDecoder,
    "cfm": CFMDecoder,
}
