"""Variance and duration predictors and the style encoder (counterpart of
``speechflow_tpu/models/tts/predictors.py``: ``VariancePredictor``,
``TokenLevelDP``, ``GaussianMixtureVAE`` and ``StyleEncoder``).

The style encoder's draws can be given: ``eps`` is the VAE's (or GMVAE's)
standard normal sample, so that a test injects JAX's; without it the sample
comes from ``generator``. ``GaussianMixtureVAE``'s ``mean_priors`` start
uniform in [-2, 2) (from torch's global generator unless given).
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn as nn

from speechflow_torch.models.tts.common import ConvStack
from speechflow_torch.utils.masks import apply_mask, masked_mean, sequence_mask

__all__ = ["VariancePredictor", "TokenLevelDP", "GaussianMixtureVAE", "StyleEncoder"]


class VariancePredictor(nn.Module):
    """Conv stack -> per-position scalar."""

    def __init__(self, dim_in: int, dim: int = 256, n_layers: int = 3,
                 kernel_size: int = 5, dropout: float = 0.1):
        super().__init__()
        self.stack = ConvStack(dim_in, dim, dim, n_layers, kernel_size, dropout)
        self.out = nn.Linear(dim, 1)

    def forward(self, x: torch.Tensor, lengths: tp.Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        v = self.out(self.stack(x, deterministic))[..., 0]
        if lengths is not None:
            v = apply_mask(v, sequence_mask(lengths, v.shape[1]))
        return v


class TokenLevelDP(nn.Module):
    """Duration predictor in the log(1 + d) domain."""

    def __init__(self, dim_in: int, dim: int = 256, n_layers: int = 2,
                 kernel_size: int = 3, dropout: float = 0.1):
        super().__init__()
        self.stack = ConvStack(dim_in, dim, dim, n_layers, kernel_size, dropout)
        self.out = nn.Linear(dim, 1)

    def forward(self, x: torch.Tensor, lengths: tp.Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        v = self.out(self.stack(x, deterministic))[..., 0]
        if lengths is not None:
            v = apply_mask(v, sequence_mask(lengths, v.shape[1]))
        return v

    @staticmethod
    def to_durations(log_d: torch.Tensor,
                     lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        d = torch.clamp(torch.expm1(log_d), min=0.0)
        if lengths is not None:
            d = apply_mask(d, sequence_mask(lengths, d.shape[1]))
        return d


def _sample(mu: torch.Tensor, logvar: torch.Tensor, eps: tp.Optional[torch.Tensor],
            generator: tp.Optional[torch.Generator]) -> torch.Tensor:
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    return mu + torch.exp(0.5 * logvar) * eps.to(mu.device, mu.dtype)


class GaussianMixtureVAE(nn.Module):
    """A diagonal-Gaussian posterior pulled toward a learned K-component
    mixture prior. Losses: the responsibility-weighted KL to each component
    (``gmvae_gm``) and the responsibilities' KL to uniform (``gmvae_cat``)."""

    def __init__(self, dim_in: int, latent_dim: int, n_components: int = 16,
                 mean_priors: tp.Optional[torch.Tensor] = None):
        super().__init__()
        self.mean_post = nn.Linear(dim_in, latent_dim)
        self.logvar_post = nn.Linear(dim_in, latent_dim)
        if mean_priors is None:
            mean_priors = torch.empty(n_components, latent_dim).uniform_(-2.0, 2.0)
        self.mean_priors = nn.Parameter(torch.as_tensor(mean_priors, dtype=torch.float32))
        self.logvar_priors = nn.Parameter(torch.full((n_components, latent_dim), -1.0))

    @staticmethod
    def _normal_logprob(z, mean, logvar):
        return -0.5 * (math.log(2 * math.pi) + logvar + (z - mean) ** 2 / torch.exp(logvar))

    @staticmethod
    def _normal_kl(mu_q, lv_q, mu_p, lv_p):
        return 0.5 * (lv_p - lv_q + (torch.exp(lv_q) + (mu_q - mu_p) ** 2)
                      / torch.exp(lv_p) - 1.0)

    def forward(self, pooled: torch.Tensor, deterministic: bool = True,
                eps: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None):
        mu = self.mean_post(pooled)
        logvar = torch.clamp(self.logvar_post(pooled), -8.0, 8.0)
        if deterministic:
            return mu, {}
        z = _sample(mu, logvar, eps, generator)
        mp = self.mean_priors
        lp = torch.clamp(self.logvar_priors, -8.0, 8.0)
        k = mp.shape[0]
        logp = self._normal_logprob(z[:, None, :], mp[None], lp[None]).sum(-1)
        resp = torch.softmax(logp, dim=-1)                          # (B, K)
        kl_k = self._normal_kl(mu[:, None, :], logvar[:, None, :], mp[None],
                               lp[None]).sum(-1)                    # (B, K)
        gm = (resp * kl_k).mean(dim=0).sum()
        cat = (resp * (torch.log(resp + 1e-8) + math.log(float(k)))).sum(-1).mean()
        return z, {"gmvae_gm": gm, "gmvae_cat": cat}


class StyleEncoder(nn.Module):
    """Reference mel -> global style embedding: a conv stack, the mean over
    the valid frames, then a VAE (``use_vae``), a GMVAE (``use_gmvae``) or a
    projection. Returns ``(emb, aux)``: aux is ``(mu, logvar)`` for the VAE,
    the GMVAE's loss dict, or None."""

    def __init__(self, dim_in: int = 100, dim: int = 256, emb_dim: int = 128,
                 use_vae: bool = True, use_gmvae: bool = False,
                 gmvae_n_components: int = 16):
        super().__init__()
        self.stack = ConvStack(dim_in, dim, dim, n_layers=3, kernel_size=5, dropout=0.0)
        self.use_vae = use_vae
        self.use_gmvae = use_gmvae
        if use_gmvae:
            self.gmvae = GaussianMixtureVAE(dim, emb_dim, gmvae_n_components)
        elif use_vae:
            self.mu = nn.Linear(dim, emb_dim)
            self.logvar = nn.Linear(dim, emb_dim)
        else:
            self.proj = nn.Linear(dim, emb_dim)
        self.emb_dim = emb_dim

    def forward(self, mel: torch.Tensor, lengths: tp.Optional[torch.Tensor] = None,
                deterministic: bool = True, eps: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None):
        h = self.stack(mel, deterministic)
        pooled = (masked_mean(h, sequence_mask(lengths, mel.shape[1]), dim=1)
                  if lengths is not None else h.mean(dim=1))
        if self.use_gmvae:
            return self.gmvae(pooled, deterministic, eps, generator)
        if not self.use_vae:
            return self.proj(pooled), None
        mu = self.mu(pooled)
        logvar = torch.clamp(self.logvar(pooled), -8.0, 8.0)
        z = mu if deterministic else _sample(mu, logvar, eps, generator)
        return z, (mu, logvar)
