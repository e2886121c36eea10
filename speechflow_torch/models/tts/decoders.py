"""Decoders (counterpart of ``speechflow_tpu/models/tts/decoders.py``):
``WrapperDecoder`` and ``CFMDecoder``.

``CFMDecoder.forward_train`` is the flow-matching objective: a prior
projection gives mu; with probability ``cfg_dropout`` a row's content and
condition are replaced by the learned fake ones (the CFG training of the
batched-CFG inference); t = 1 - cos(u·π/2) for u ~ U(0, 1); x_t =
(1 - (1 - σ_min)·t)·z + t·target and the flow target - (1 - σ_min)·z, with
z ~ N(0, 1); the DiT estimator on (x_t, mu detached, content) regresses the
flow in a masked MSE. JAX draws u, z and the two drop masks from the
decoder's rng stream; here they are an argument (``CFMDraws``), drawn from a
``torch.Generator`` when not given, as ``generate`` takes its noise.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.models.tts.common import sinusoidal_embedding
from speechflow_torch.models.tts.encoders import TTS_ENCODERS, DiTEncoder
from speechflow_torch.parallel.distributed import global_count
from speechflow_torch.utils.masks import apply_mask, sequence_mask
from speechflow_torch.utils.profiler import span

__all__ = ["WrapperDecoder", "CFMDecoder", "CFMDraws", "TTS_DECODERS"]


class CFMDraws(tp.NamedTuple):
    """The random draws of one ``forward_train``: u (B,) uniform in [0, 1),
    z (B, T, n_mels) standard normal, and the CFG drop masks, content (B, 1, 1)
    and condition (B, 1), True where the row takes the fake embedding."""
    u: torch.Tensor
    z: torch.Tensor
    drop_content: torch.Tensor
    drop_condition: torch.Tensor


class WrapperDecoder(nn.Module):
    """An encoder and an output projection. The inner encoder is built without
    a dropout argument, so it keeps its default rate whatever the model's
    ``dropout`` says, as the JAX decoder builds it."""

    def __init__(self, dim_in: int, dim_out: int, inner: str = "transformer",
                 dim: int = 256, n_layers: int = 4, **kw):
        super().__init__()
        self.enc = TTS_ENCODERS[inner](dim_in=dim_in, dim_out=dim, dim=dim,
                                       n_layers=n_layers)
        self.out = nn.Linear(dim, dim_out)
        self.dim_out = dim_out

    def forward(self, x: torch.Tensor, lengths: tp.Optional[torch.Tensor] = None,
                cond: tp.Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        out = self.out(self.enc(x, lengths, cond, deterministic))
        if lengths is not None:
            out = apply_mask(out, sequence_mask(lengths, out.shape[1]))
        return out


class CFMDecoder(nn.Module):
    """Conditional flow matching decoder: a prior projection gives mu, and a
    fixed-step Euler solve over the cosine time grid integrates the DiT
    estimator from the initial noise, with batched classifier-free guidance
    when ``cfg_scale > 0``."""

    def __init__(self, dim_in: int, dim_out: int, dim: int = 256, n_layers: int = 4,
                 n_heads: int = 4, cond_dim: int = 256, sigma_min: float = 1e-4,
                 n_timesteps: int = 30, temperature: float = 0.667,
                 cfg_scale: float = 0.0, cfg_dropout: float = 0.1, **kw):
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
        self.sigma_min = sigma_min
        self.n_timesteps = n_timesteps
        self.temperature = temperature
        self.cfg_scale = cfg_scale
        self.cfg_dropout = cfg_dropout
        self.cond_dim = cond_dim
        self.dim = dim
        self.dim_out = dim_out

    def _time_emb(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        emb = sinusoidal_embedding(t * 1000.0, self.dim).to(dtype)
        return self.time_mlp2(F.silu(self.time_mlp1(emb)))

    def _dphi(self, x_t, mu, content, t, cond, lengths, deterministic: bool = True):
        c_full = torch.cat([cond, self._time_emb(t, x_t.dtype)], dim=-1)
        est_in = torch.cat([x_t, mu, content], dim=-1)
        return self.estimator(est_in, lengths, c_full, deterministic)

    def draw(self, batch: int, shape: tp.Sequence[int], device: torch.device,
             generator: tp.Optional[torch.Generator] = None) -> CFMDraws:
        """u, z and the CFG drop masks of a training step, from ``generator``
        (on its own device; the global generator when None), on ``device``."""
        gdev = generator.device if generator is not None else device
        u = torch.rand(batch, generator=generator, device=gdev)
        z = torch.randn(tuple(shape), generator=generator, device=gdev)
        drop_c = torch.rand((batch, 1, 1), generator=generator, device=gdev) < self.cfg_dropout
        drop_e = torch.rand((batch, 1), generator=generator, device=gdev) < self.cfg_dropout
        return CFMDraws(*(a.to(device) for a in (u, z, drop_c, drop_e)))

    def forward_train(self, content: torch.Tensor, lengths: torch.Tensor,
                      target: torch.Tensor, cond: tp.Optional[torch.Tensor] = None,
                      draws: tp.Optional[CFMDraws] = None,
                      generator: tp.Optional[torch.Generator] = None
                      ) -> tp.Tuple[torch.Tensor, tp.Dict[str, torch.Tensor]]:
        """Returns (mu, {"cfm": the masked flow-matching MSE}); ``target`` is
        the mel (B, T, dim_out). The estimator runs its training call
        (``deterministic=False``: the plain attention path)."""
        mu = self.prior(content)
        b = content.shape[0]
        if draws is None:
            draws = self.draw(b, target.shape, content.device, generator)
        if self.cfg_dropout > 0:
            content = torch.where(draws.drop_content,
                                  self.fake_content.to(content.dtype)[None, None, :], content)
            if cond is not None:
                cond = torch.where(draws.drop_condition,
                                   self.fake_condition.to(cond.dtype)[None, :], cond)
        if cond is None:
            cond = mu.new_zeros(b, self.cond_dim)
        t = 1.0 - torch.cos(draws.u * (0.5 * math.pi))
        t_ = t[:, None, None]
        z = draws.z.to(target.dtype)
        x_t = (1.0 - (1.0 - self.sigma_min) * t_) * z + t_ * target
        flow_target = target - (1.0 - self.sigma_min) * z
        v = self._dphi(x_t.to(mu.dtype), mu.detach(), content, t, cond, lengths,
                       deterministic=False)
        mask = sequence_mask(lengths, target.shape[1])[..., None].to(v.dtype)
        cfm = torch.sum((v - flow_target) ** 2 * mask) / torch.clamp(
            global_count(mask.sum() * target.shape[-1]), min=1.0)
        return mu, {"cfm": cfm}

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
        with span("tts.cfm"):
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
