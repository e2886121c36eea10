"""GlowTTS forced aligner: a text encoder, a flow decoder and the monotonic
alignment search (counterpart of ``speechflow_tpu/models/aligner/model.py``).

The text encoder gives each token a Gaussian (mu, logstd) over the squeezed
mel; the flow maps the mel frames to latents z with a log-determinant; the
token x frame log-likelihood grid is three products; ``ops.mas.maximum_path``
finds the monotonic alignment, whose per-token frame counts are the
durations. Training maximises the flow's likelihood under that hard path
and regresses log(1 + duration). ``align`` is the deterministic call the
annotator reads; there the encoder attends through the fused kernel.
``generate`` inverts the flow from the expanded token Gaussians.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch
import torch.nn as nn

from speechflow_torch.models.aligner.flows import FlowSpecDecoder
from speechflow_torch.models.layers import flax_init_
from speechflow_torch.models.tts.encoders import TransformerEncoder
from speechflow_torch.ops.length_regulator import length_regulate_hard
from speechflow_torch.ops.mas import maximum_path
from speechflow_torch.training.base_model import BaseModelParams

__all__ = ["GlowTTSAligner", "GlowTTSParams"]


@dataclasses.dataclass
class GlowTTSParams(BaseModelParams):
    n_symbols: int = 100
    n_speakers: int = 1
    n_langs: int = 1
    n_mels: int = 100
    encoder_dim: int = 192
    encoder_layers: int = 4
    encoder_heads: int = 2
    n_flows: int = 6
    flow_hidden: int = 192
    speaker_emb_dim: int = 64
    lang_emb_dim: int = 16
    mean_only: bool = False           # predict mu only (logstd = 0)


class GlowTTSAligner(nn.Module):
    def __init__(self, params: GlowTTSParams):
        super().__init__()
        p = self.p = params
        self.token_emb = nn.Embedding(p.n_symbols, p.encoder_dim)
        cond_dim = 0
        if p.n_speakers > 1:
            self.speaker_emb = nn.Embedding(p.n_speakers, p.speaker_emb_dim)
            cond_dim += p.speaker_emb_dim
        if p.n_langs > 1:
            self.lang_emb = nn.Embedding(p.n_langs, p.lang_emb_dim)
            cond_dim += p.lang_emb_dim
        self.cond_dim = cond_dim or None
        self.encoder = TransformerEncoder(dim_in=p.encoder_dim, dim_out=p.encoder_dim,
                                          dim=p.encoder_dim, n_layers=p.encoder_layers,
                                          n_heads=p.encoder_heads)
        self.proj = nn.Linear(p.encoder_dim, (1 if p.mean_only else 2) * p.n_mels)
        self.dur_proj = nn.Linear(p.encoder_dim, 1)
        self.flow = FlowSpecDecoder(p.n_mels, p.n_flows, p.flow_hidden, cond_dim=self.cond_dim)
        flax_init_(self)

    def _condition(self, inputs) -> tp.Optional[torch.Tensor]:
        parts = []
        if self.p.n_speakers > 1 and inputs.speaker_id is not None:
            parts.append(self.speaker_emb(torch.clamp(inputs.speaker_id.long(), min=0)))
        if self.p.n_langs > 1 and inputs.lang_id is not None:
            parts.append(self.lang_emb(torch.clamp(inputs.lang_id.long(), min=0)))
        return torch.cat(parts, dim=-1) if parts else None

    def encode_text(self, inputs, training: bool):
        """(mu, logstd (clipped to [-7, 5]), log-duration) a token."""
        x = self.token_emb(inputs.transcription.long())
        h = self.encoder(x, inputs.transcription_lengths, deterministic=not training)
        stats = self.proj(h)
        if self.p.mean_only:
            mu, logstd = stats, torch.zeros_like(stats)
        else:
            mu, logstd = stats.chunk(2, dim=-1)
            logstd = torch.clamp(logstd, -7.0, 5.0)
        return mu, logstd, self.dur_proj(h.detach())[..., 0]

    @staticmethod
    def likelihood_grid(z: torch.Tensor, mu: torch.Tensor, logstd: torch.Tensor
                        ) -> torch.Tensor:
        """log N(z_t; mu_n, sigma_n) summed over the mel bins: (B, N, T)."""
        inv_var = torch.exp(-2.0 * logstd)
        const = torch.sum(-0.5 * math.log(2 * math.pi) - logstd - 0.5 * mu ** 2 * inv_var,
                          dim=-1)
        cross = torch.einsum("bnd,btd->bnt", mu * inv_var, z)
        quad = -0.5 * torch.einsum("bnd,btd->bnt", inv_var, z * z)
        return quad + cross + const[..., None]

    def forward(self, inputs, training: tp.Optional[bool] = None) -> tp.Dict[str, torch.Tensor]:
        """The training call (None: ``self.training``): z, logdet, mel_lengths,
        the path's per-frame token stats (mu_t, logstd_t), path, durations
        (frames a token) and log_dur_pred."""
        training = self.training if training is None else training
        mu, logstd, log_dur = self.encode_text(inputs, training)
        z, logdet = self.flow(inputs.mel, inputs.mel_lengths, self._condition(inputs))
        t2 = (z.shape[1] // 2) * 2
        z = z[:, :t2]
        mel_lens = torch.clamp(inputs.mel_lengths // 2 * 2, max=t2)
        grid = self.likelihood_grid(z, mu, logstd)
        path = maximum_path(grid.detach(), inputs.transcription_lengths, mel_lens)
        return {"z": z, "logdet": logdet, "mel_lengths": mel_lens,
                "mu_t": torch.einsum("bnt,bnd->btd", path, mu),
                "logstd_t": torch.einsum("bnt,bnd->btd", path, logstd),
                "path": path, "durations": path.sum(dim=-1), "log_dur_pred": log_dur}

    @torch.no_grad()
    def align(self, inputs) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """(durations (B, N) in frames, path (B, N, T)), the deterministic call."""
        out = self(inputs, training=False)
        return out["durations"], out["path"]

    @torch.no_grad()
    def generate(self, inputs, durations: tp.Optional[torch.Tensor] = None,
                 noise_scale: float = 0.33, t_out: tp.Optional[int] = None,
                 noise: tp.Optional[torch.Tensor] = None,
                 generator: tp.Optional[torch.Generator] = None):
        """Inverse-flow synthesis: the token Gaussians expanded by ``durations``
        (else the rounded predicted ones) to ``t_out`` frames (4·n_mels by
        default, even), ``mu + exp(logstd)·noise_scale·noise`` (``noise`` a
        standard normal of (B, t_out, n_mels), else drawn from ``generator``)
        through the inverse flow -> (mel, lengths)."""
        mu, logstd, log_dur = self.encode_text(inputs, training=False)
        if durations is None:
            durations = torch.round(torch.clamp(torch.expm1(log_dur), min=0.0))
        t_out = ((t_out or int(self.p.n_mels * 4)) // 2) * 2
        mu_f, _ = length_regulate_hard(mu, durations, t_out)
        logstd_f, _ = length_regulate_hard(logstd, durations, t_out)
        lens = torch.clamp(durations.sum(-1).to(torch.int32), 2, t_out) // 2 * 2
        if noise is None:
            noise = torch.randn(mu_f.shape, device=mu_f.device, generator=generator)
        z = mu_f + torch.exp(logstd_f) * noise_scale * noise.to(mu_f.dtype)
        mel, _ = self.flow(z, lens, self._condition(inputs), reverse=True)
        return mel, lens
