"""Variance and duration predictors and the style encoder (counterpart of
``speechflow_tpu/models/tts/predictors.py``: ``VariancePredictor``,
``TokenLevelDP``, ``GaussianMixtureVAE``, ``StyleEncoder``, the LSGAN
``SignalDiscriminator`` of the ``use_discriminator`` variances and the in-model
aligner ``GradTTSFA`` of ``use_gradtts_fa``, whose monotonic alignment search is
``ops.mas.maximum_path``).

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
import torch.nn.functional as F

from speechflow_torch.models.layers import Conv1d, layer_norm
from speechflow_torch.models.tts.common import ConvStack
from speechflow_torch.parallel.distributed import global_count
from speechflow_torch.utils.masks import apply_mask, masked_mean, sequence_mask

__all__ = ["TTS_VARIANCE_PREDICTORS", "VariancePredictor", "TokenLevelDP", "GaussianMixtureVAE", "StyleEncoder",
           "SignalDiscriminator", "GradTTSFA"]


class VariancePredictor(nn.Module):
    """Conv stack -> per-position scalar, through ``activation_out``
    (``softplus``, ``relu``; None: as it is)."""

    def __init__(self, dim_in: int, dim: int = 256, n_layers: int = 3,
                 kernel_size: int = 5, dropout: float = 0.1,
                 activation_out: tp.Optional[str] = None):
        super().__init__()
        self.stack = ConvStack(dim_in, dim, dim, n_layers, kernel_size, dropout)
        self.out = nn.Linear(dim, 1)
        self.activation_out = activation_out

    def forward(self, x: torch.Tensor, lengths: tp.Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        v = self.out(self.stack(x, deterministic))[..., 0]
        if self.activation_out == "softplus":
            v = F.softplus(v)
        elif self.activation_out == "relu":
            v = F.relu(v)
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

    def sample_prior(self, n: int = 1, sigma_multiplier: float = 1.0,
                     generator: tp.Optional[torch.Generator] = None,
                     idx: tp.Optional[torch.Tensor] = None,
                     noise: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """``n`` style embeddings drawn from the mixture prior, each from a
        component picked uniformly: mean + ``sigma_multiplier``·std·noise
        (std from the clipped log-variance). The component indices (``idx``,
        (n,)) and standard normals (``noise``, (n, latent_dim)) come from
        ``generator`` unless given."""
        k, d = self.mean_priors.shape
        dev = self.mean_priors.device
        if idx is None:
            idx = torch.randint(0, k, (n,), generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(n, d, generator=generator, device=dev,
                                dtype=self.mean_priors.dtype)
        idx = torch.as_tensor(idx, device=dev, dtype=torch.long)
        std = torch.exp(0.5 * torch.clamp(self.logvar_priors[idx], -8.0, 8.0))
        return self.mean_priors[idx] + sigma_multiplier * std * torch.as_tensor(noise).to(std)


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
        pooled = (masked_mean(h, sequence_mask(lengths, mel.shape[1]), axis=1)
                  if lengths is not None else h.mean(dim=1))
        if self.use_gmvae:
            return self.gmvae(pooled, deterministic, eps, generator)
        if not self.use_vae:
            return self.proj(pooled), None
        mu = self.mu(pooled)
        logvar = torch.clamp(self.logvar(pooled), -8.0, 8.0)
        z = mu if deterministic else _sample(mu, logvar, eps, generator)
        return z, (mu, logvar)


class SignalDiscriminator(nn.Module):
    """A per-position LSGAN discriminator over (context, 1-D signal) pairs: a
    conv trunk over the masked context, the signal projected and concatenated,
    two more convs and a sigmoid head."""

    def __init__(self, ctx_dim: int, dim: int = 192, kernel_size: int = 3):
        super().__init__()
        self.conv1 = Conv1d(ctx_dim, dim, kernel_size)
        self.norm1 = layer_norm(dim)
        self.conv2 = Conv1d(dim, dim, kernel_size)
        self.norm2 = layer_norm(dim)
        self.signal_proj = nn.Linear(1, dim)
        self.out_conv1 = Conv1d(2 * dim, dim, kernel_size)
        self.out_norm1 = layer_norm(dim)
        self.out_conv2 = Conv1d(dim, dim, kernel_size)
        self.out_norm2 = layer_norm(dim)
        self.head = nn.Linear(dim, 1)

    def _trunk(self, ctx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.norm1(torch.relu(self.conv1(ctx * mask)))
        return self.norm2(torch.relu(self.conv2(h * mask)))

    def _prob(self, h: torch.Tensor, signal: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        z = torch.cat([h, self.signal_proj(signal[..., None].to(h.dtype))], dim=-1)
        z = self.out_norm1(torch.relu(self.out_conv1(z * mask)))
        z = self.out_norm2(torch.relu(self.out_conv2(z * mask)))
        return torch.sigmoid(self.head(z)[..., 0])

    def lsgan_losses(self, context: torch.Tensor, real: torch.Tensor, fake: torch.Tensor,
                     lengths: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        """{'disc_loss', 'gen_loss'}: the discriminator's side sees the context,
        the real and the fake signals detached; the generator's lets gradients
        reach the context and the fake."""
        mask = sequence_mask(lengths, context.shape[1]).to(context.dtype)[..., None]

        def mmean(v):
            return (v * mask[..., 0]).sum() / torch.clamp(global_count(mask.sum()), min=1.0)

        h_d = self._trunk(context.detach(), mask)
        disc = (mmean((1.0 - self._prob(h_d, real.detach(), mask)) ** 2)
                + mmean(self._prob(h_d, fake.detach(), mask) ** 2))
        gen = mmean((1.0 - self._prob(self._trunk(context, mask), fake, mask)) ** 2)
        return {"disc_loss": disc, "gen_loss": gen}


class GradTTSFA(nn.Module):
    """In-model forced aligner: a conv encoder maps the content to per-token mel
    means, monotonic alignment search against the target mel under a unit
    Gaussian gives the durations (and their losses), and a log-duration
    predictor gives them at inference (exp(logw))."""

    def __init__(self, dim_in: int, feat_dim: int, dim: int = 256, dp_dim: int = 256, **kw):
        super().__init__()
        self.encoder = ConvStack(dim_in, dim, dim, n_layers=2, kernel_size=3, dropout=0.1)
        self.proj = nn.Linear(dim, feat_dim)
        self.dp = ConvStack(dim, dp_dim, dp_dim, n_layers=2, kernel_size=3, dropout=0.1)
        self.dp_out = nn.Linear(dp_dim, 1)
        self.feat_dim = feat_dim

    def _encode(self, x: torch.Tensor, deterministic: bool):
        h = self.encoder(x, deterministic)
        return self.proj(h), self.dp_out(self.dp(h, deterministic))[..., 0]

    def predict(self, x: torch.Tensor, token_lengths: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        _, logw = self._encode(x, deterministic)
        d = torch.exp(logw.float())
        return apply_mask(d, sequence_mask(token_lengths, d.shape[1]))

    def align(self, x: torch.Tensor, token_lengths: torch.Tensor, mel: torch.Tensor,
              mel_lengths: torch.Tensor, deterministic: bool = False):
        """(MAS durations (B, N), the path (B, N, T), {'fa_duration', 'fa_prior'})."""
        from speechflow_torch.ops.mas import maximum_path

        mu_x, logw = self._encode(x, deterministic)
        mu_x, logw, mel = mu_x.float(), logw.float(), mel.float()
        c = self.feat_dim
        log2pi = math.log(2 * math.pi)
        with torch.no_grad():
            log_prior = (-0.5 * torch.einsum("btc,btc->bt", mel, mel)[:, None, :]
                         + torch.einsum("bnc,btc->bnt", mu_x, mel)
                         - 0.5 * (mu_x ** 2).sum(-1)[:, :, None] - 0.5 * log2pi * c)
            attn = maximum_path(log_prior, token_lengths, mel_lengths)
        dura = attn.sum(-1)
        tok_mask = sequence_mask(token_lengths, x.shape[1]).float()
        logw_tgt = torch.log(dura + 1e-8) * tok_mask
        dura_loss = (logw * tok_mask - logw_tgt).abs().sum() / torch.clamp(
            global_count(tok_mask.sum()), min=1.0)
        mu_y = torch.einsum("bnt,bnc->btc", attn, mu_x)
        mel_mask = sequence_mask(mel_lengths, mel.shape[1]).float()[..., None]
        prior = (0.5 * ((mel - mu_y) ** 2 + log2pi) * mel_mask).sum()
        prior_loss = prior / torch.clamp(global_count(mel_mask.sum() * c), min=1.0)
        return dura, attn, {"fa_duration": dura_loss, "fa_prior": prior_loss}


#: the variance adaptor's predictors by their config names
TTS_VARIANCE_PREDICTORS: tp.Dict[str, type] = {
    "variance": VariancePredictor,
    "token_level_dp": TokenLevelDP,
    "signal_discriminator": SignalDiscriminator,
    "gradtts_fa": GradTTSFA,
}
