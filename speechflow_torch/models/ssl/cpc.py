"""Contrastive Predictive Coding (counterpart of
``speechflow_tpu/models/ssl/cpc.py``): a strided-conv waveform encoder gives
latents z_t, a forward GRU sums them into contexts c_t (the ``ssl_feat`` of
``data/processors/embeddings.py::make_cpc_hook``), and InfoNCE trains one
linear prediction of z_{t+k} from c_t per step offset k against the batch's
other positions.

Channels-last like the JAX module: each encoder conv is ``nnx.Conv`` with XLA
SAME padding at its stride (``models.layers.Conv1d``), then the tanh GELU
and ``nnx.LayerNorm`` (eps 1e-6); the GRU is ``nnx.RNN(nnx.GRUCell)``
(``models.layers.RNN``) over every step, padded ones too. The weights start
from flax's initialisers.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from speechflow_torch.models.layers import RNN, Conv1d, flax_init_, layer_norm
from speechflow_torch.training.base_model import BaseModelParams
from speechflow_torch.utils.device import resolve_device

__all__ = ["CPCParams", "CPCModel", "cpc_infonce_loss", "train_cpc"]


@dataclasses.dataclass
class CPCParams(BaseModelParams):
    sample_rate: int = 24000
    channels: int = 128
    latent_dim: int = 128
    context_dim: int = 128
    strides: tp.Tuple[int, ...] = (5, 4, 2, 2, 2)   # total hop = 160
    kernel_sizes: tp.Tuple[int, ...] = (10, 8, 4, 4, 4)
    n_predict_steps: int = 4


class CPCModel(nn.Module):
    def __init__(self, params: CPCParams):
        super().__init__()
        p = self.p = params
        ins = [1] + [p.channels] * (len(p.strides) - 1)
        self.encoder = nn.ModuleList(Conv1d(c, p.channels, k, stride=s)
                                     for c, k, s in zip(ins, p.kernel_sizes, p.strides))
        self.enc_norms = nn.ModuleList(layer_norm(p.channels) for _ in p.strides)
        self.enc_proj = nn.Linear(p.channels, p.latent_dim)
        self.context = RNN("gru", p.latent_dim, p.context_dim)
        self.predictors = nn.ModuleList(nn.Linear(p.context_dim, p.latent_dim)
                                        for _ in range(p.n_predict_steps))
        self.hop = int(np.prod(p.strides))
        self.dim = p.context_dim
        flax_init_(self)

    def encode(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, T', latent_dim) local latents z."""
        x = wav[..., None]
        for conv, norm in zip(self.encoder, self.enc_norms):
            x = norm(F.gelu(conv(x), approximate="tanh"))
        return self.enc_proj(x)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, T', context_dim) SSL features (the c_t stream)."""
        return self.context(self.encode(wav))

    def features_and_latents(self, wav: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        z = self.encode(wav)
        return self.context(z), z


def cpc_infonce_loss(model: CPCModel, wav: torch.Tensor) -> torch.Tensor:
    """InfoNCE over in-batch negatives, averaged over the predict steps: for
    each k, the (N, N) logits of every prediction against every true latent
    (N = B·(T'-k)) over sqrt(D), cross-entropy with the diagonal."""
    c, z = model.features_and_latents(wav)
    b, t, d = z.shape
    total = z.new_zeros(())
    for k, head in enumerate(model.predictors, start=1):
        if t <= k:
            continue
        n = b * (t - k)
        pred = head(c[:, :-k]).reshape(n, d)
        tgt = z[:, k:].reshape(n, d)
        logits = pred @ tgt.T / math.sqrt(d)
        total = total + F.cross_entropy(logits, torch.arange(n, device=logits.device))
    return total / len(model.predictors)


def train_cpc(waves: tp.Sequence[np.ndarray], sr: int = 24000, steps: int = 150,
              batch: int = 4, chunk_s: float = 1.0, lr: float = 2e-4, seed: int = 0,
              params: tp.Optional[CPCParams] = None,
              device: tp.Union[str, torch.device, None] = None,
              losses: tp.Optional[tp.List[float]] = None) -> CPCModel:
    """JAX's ``train_cpc``: ``steps`` ``optax.adam(lr)`` steps on batches of
    ``batch`` random ``chunk_s`` chunks of ``waves`` (numpy's generator seeded
    ``seed`` draws the waves and offsets in JAX's order; a short wave is
    zero-padded); the weights start from flax's initialisers under
    ``torch.manual_seed(seed)``. Trains on ``device`` (the GPU unless
    ``device="cpu"``) and returns the model in eval mode; each step's loss is
    appended to ``losses`` when given."""
    from speechflow_torch.training.optimizer import optax_optimizer

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CPCModel(params or CPCParams(sample_rate=sr))
    model = model.to(dev).train()
    opt = optax_optimizer(model.parameters(), "adam", lr)
    n = int(chunk_s * sr)
    for _ in range(steps):
        xs = []
        for _ in range(batch):
            w = waves[int(rng.integers(0, len(waves)))]
            if len(w) < n:
                w = np.pad(w, (0, n - len(w)))
            start = int(rng.integers(0, max(len(w) - n, 1)))
            xs.append(w[start:start + n])
        wav = torch.from_numpy(np.stack(xs).astype(np.float32)).to(dev)
        opt.zero_grad(set_to_none=True)
        loss = cpc_infonce_loss(model, wav)
        loss.backward()
        opt.step()
        if losses is not None:
            losses.append(loss.detach())
    if losses is not None:
        losses[:] = [float(v) for v in losses]
    return model.eval()
