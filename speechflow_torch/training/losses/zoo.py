"""The loss zoo (counterpart of ``speechflow_tpu/training/losses/zoo.py``):
the twelve losses of JAX's ``LOSSES`` under the same names, and ``build_loss``.

Each is JAX's formula in torch ops, differentiable by autograd; a mean over
the batch divides by ``parallel.distributed.global_count`` of its count (in a
data-parallel step the global batch's; else the count itself). Where JAX's
semantics are particular, the port keeps them: ``MLELoss`` accepts ``n_dims``
and does not use it, ``GuidedAttentionLoss`` masks only when both lengths are
given, ``SoftDTWLoss`` ignores ``lengths``, ``SSIMLoss`` uses uniform 11-wide
windows over three dyadic scales (weights 0.1, 0.2, 0.4) and stops at a scale
whose side is under 11, ``InverseSpeakerLoss`` is the softmax cross-entropy of
integer labels.

JAX's soft-DTW scans rows inside a scan of columns: T² steps one after another.
The port's runs the same recursion along anti-diagonals: every cell with
``i + j = d`` depends only on earlier diagonals, so it takes ``Tx + Ty - 1``
steps, each over the batch and the whole diagonal at once.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F

from speechflow_torch.parallel.distributed import global_count
from speechflow_torch.training.losses.base import BaseLoss
from speechflow_torch.utils.masks import sequence_mask

__all__ = [
    "SpectralLoss", "GateLoss", "RegressionLoss", "VAELoss", "MLELoss",
    "GuidedAttentionLoss", "InverseSpeakerLoss", "DurationLoss", "SoftDTWLoss",
    "DiffSpectralLoss", "SSIMLoss", "CTCLoss",
    "LOSSES", "build_loss",
]


def _masked_mean(err: torch.Tensor, lengths: tp.Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of ``err`` (B, T, ...) over the first ``lengths`` positions of each row."""
    if lengths is None:
        return err.mean()
    mask = sequence_mask(lengths, err.shape[1])
    while mask.ndim < err.ndim:
        mask = mask[..., None]
    m = mask.to(err.dtype)
    return (err * m).sum() / torch.clamp(global_count(m.expand_as(err).sum()), min=1e-8)


class SpectralLoss(BaseLoss):
    """L1 / L2 / Huber over a spectrogram, or the mean of its stacked stages'
    errors (S, B, T, n_mels), with length masking."""

    def __init__(self, kind: str = "l1", **kwargs):
        super().__init__(**kwargs)
        if kind not in ("l1", "l2", "huber"):
            raise ValueError(kind)
        self.kind = kind

    def compute(self, output: torch.Tensor, target: torch.Tensor,
                lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        if output.ndim == target.ndim + 1:  # stacked per-stage predictions
            err = torch.stack([self._err(o, target) for o in output]).mean(0)
        else:
            err = self._err(output, target)
        return _masked_mean(err, lengths)

    def _err(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == "l1":
            return (a - b).abs()
        if self.kind == "l2":
            return (a - b) ** 2
        return F.huber_loss(a, b, reduction="none", delta=1.0)


class GateLoss(BaseLoss):
    """BCE with logits on the stop token."""

    def __init__(self, pos_weight: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.pos_weight = pos_weight

    def compute(self, output: torch.Tensor, target: torch.Tensor,
                lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        err = -(self.pos_weight * target * F.logsigmoid(output)
                + (1.0 - target) * F.logsigmoid(-output))
        return _masked_mean(err, lengths)


class RegressionLoss(BaseLoss):
    """MSE or L1 of a variance predictor; ``log_domain`` takes the target's
    log(1 + max(target, 0))."""

    def __init__(self, kind: str = "l2", log_domain: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.kind = kind
        self.log_domain = log_domain

    def compute(self, output: torch.Tensor, target: torch.Tensor,
                lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.log_domain:
            target = torch.log1p(torch.clamp(target, min=0.0))
        err = (output - target).abs() if self.kind == "l1" else (output - target) ** 2
        return _masked_mean(err, lengths)


class DurationLoss(RegressionLoss):
    """Log-domain duration regression (L2 unless ``kind`` says otherwise)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("kind", "l2")
        super().__init__(log_domain=True, **kwargs)


def _batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of ``x``, over the global batch's count."""
    return x.sum() / global_count(x.new_tensor(float(x.numel())))


class VAELoss(BaseLoss):
    """KL(N(mu, exp(logvar)) || N(0, 1)), the mean over every element."""

    def compute(self, output: tp.Tuple[torch.Tensor, torch.Tensor], target=None,
                lengths=None) -> torch.Tensor:
        mu, logvar = output
        return _batch_mean(-0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar)))


class MLELoss(BaseLoss):
    """Glow's negative log-likelihood of (z, logdet): ``(sum(z²)/2 - sum(logdet))``
    over the valid elements of z, plus log(2π)/2. ``n_dims`` is accepted and
    unused, as in JAX."""

    def compute(self, output: tp.Tuple[torch.Tensor, torch.Tensor], target=None,
                lengths: tp.Optional[torch.Tensor] = None, n_dims: int = 1) -> torch.Tensor:
        z, logdet = output
        if lengths is not None:
            mask = sequence_mask(lengths, z.shape[1])[..., None].to(z.dtype)
            denom = mask.sum() * z.shape[-1]
            zsum = (0.5 * z ** 2 * mask).sum()
        else:
            denom = z.new_tensor(float(z.numel()))
            zsum = (0.5 * z ** 2).sum()
        return (zsum - logdet.sum()) / global_count(denom) + 0.5 * math.log(2 * math.pi)


class GuidedAttentionLoss(BaseLoss):
    """The diagonal guide over an attention (B, T_out, T_in): each weight times
    ``1 - exp(-(j/L_in - i/L_out)² / 2σ²)``; the mean over the cells inside both
    lengths when both are given, else over every cell."""

    def __init__(self, sigma: float = 0.4, **kwargs):
        super().__init__(**kwargs)
        self.sigma = sigma

    def compute(self, output: torch.Tensor, target=None,
                in_lengths: tp.Optional[torch.Tensor] = None,
                out_lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        _, t_out, t_in = output.shape
        i = torch.arange(t_out, device=output.device, dtype=output.dtype)[None, :, None]
        j = torch.arange(t_in, device=output.device, dtype=output.dtype)[None, None, :]
        li = out_lengths.to(output.dtype)[:, None, None] if out_lengths is not None else t_out
        lj = in_lengths.to(output.dtype)[:, None, None] if in_lengths is not None else t_in
        w = 1.0 - torch.exp(-((j / lj - i / li) ** 2) / (2 * self.sigma ** 2))
        loss = output * w
        if out_lengths is not None and in_lengths is not None:
            mask = ((i < li) & (j < lj)).to(output.dtype)
            return (loss * mask).sum() / torch.clamp(global_count(mask.sum()), min=1.0)
        return _batch_mean(loss)


class InverseSpeakerLoss(BaseLoss):
    """Softmax cross-entropy of (B, n_speakers) logits and integer labels, the
    batch mean (the gradient-reversal speaker classifier's)."""

    def compute(self, output: torch.Tensor, target: torch.Tensor,
                lengths=None) -> torch.Tensor:
        return _batch_mean(F.cross_entropy(output, target.long(), reduction="none"))


#: the value of the cells outside the grid, as JAX's (a virtual D[-1, -1] is 0)
SOFT_DTW_BIG = 1e9


def _softmin(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, gamma: float) -> torch.Tensor:
    """``-γ log(e^(-a/γ) + e^(-b/γ) + e^(-c/γ))``."""
    return -gamma * torch.logsumexp(torch.stack([a, b, c]) / -gamma, dim=0)


def soft_dtw(cost: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """Soft-DTW of a batch of cost matrices (B, Tx, Ty) as the JAX package's
    scan computes it: ``D[i, j] = cost[i, j] + softmin(D[i-1, j], D[i, j-1], E)``
    where E, the diagonal predecessor, is the virtual D[-1, -1] = 0 at (0, 0),
    ``D[i-2, j-1]`` from the third row on (JAX's scan carries its previous row's
    diagonal one row further: ROADMAP §3), and ``SOFT_DTW_BIG`` at every other
    cell, as is every cell outside the grid. One anti-diagonal a step (see the
    module docstring); returns D[Tx-1, Ty-1], (B,)."""
    b, tx, ty = cost.shape
    big = cost.new_full((), SOFT_DTW_BIG)
    rows = torch.arange(tx, device=cost.device)
    # diagonal d (i + j = d) as a vector over i in [0, tx); cells off the grid are BIG
    back1 = back2 = back3 = big.expand(b, tx)
    for d in range(tx + ty - 1):
        cols = d - rows
        valid = (cols >= 0) & (cols < ty)
        c = cost[:, rows, cols.clamp(0, ty - 1)]
        up = torch.cat([big.expand(b, 1), back1[:, :-1]], dim=1)
        first = cost.new_zeros(b, 1) if d == 0 else big.expand(b, 1)
        diag = torch.cat([first, big.expand(b, min(1, tx - 1)), back3[:, :-2]], dim=1)
        cell = c + _softmin(up, back1, diag, gamma)
        back1, back2, back3 = torch.where(valid, cell, big), back1, back2
    return back1[:, tx - 1]


class SoftDTWLoss(BaseLoss):
    """Soft-DTW between (B, T, D) or (B, T) sequences over squared distances,
    the batch mean over ``Tx + Ty`` (DILATE's shape term); ``lengths`` is ignored."""

    def __init__(self, gamma: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.gamma = gamma

    def compute(self, output: torch.Tensor, target: torch.Tensor, lengths=None
                ) -> torch.Tensor:
        if output.ndim == 2:
            output, target = output[..., None], target[..., None]
        cost = ((output[:, :, None, :] - target[:, None, :, :]) ** 2).sum(-1)
        final = soft_dtw(cost, self.gamma)
        return _batch_mean(final) / (cost.shape[1] + cost.shape[2])


class DiffSpectralLoss(SpectralLoss):
    """``SpectralLoss`` of the first differences along time (lengths less one)."""

    def compute(self, output: torch.Tensor, target: torch.Tensor,
                lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        d_out = output[:, 1:] - output[:, :-1]
        d_tgt = target[:, 1:] - target[:, :-1]
        lengths = None if lengths is None else torch.clamp(lengths - 1, min=0)
        return super().compute(d_out, d_tgt, lengths)


def _ssim_2d(x: torch.Tensor, y: torch.Tensor, win: int = 11
             ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """SSIM and its contrast-structure term over (B, H, W) images in [0, 1] with
    a uniform ``win`` x ``win`` window (VALID): the two maps."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2

    def pool(a):
        return F.avg_pool2d(a[:, None], win, stride=1)[:, 0]

    mx, my = pool(x), pool(y)
    vx = pool(x * x) - mx * mx
    vy = pool(y * y) - my * my
    cxy = pool(x * y) - mx * my
    lum = (2 * mx * my + c1) / (mx * mx + my * my + c1)
    cs = (2 * cxy + c2) / (vx + vy + c2)
    return lum * cs, cs


class SSIMLoss(BaseLoss):
    """``1 - MS-SSIM`` of two (B, T, C) spectrograms taken as images over
    [min_value, max_value] (clipped), frames past ``lengths`` at ``min_value``;
    see the module docstring for the scales."""

    def __init__(self, min_value: float = -4.0, max_value: float = 4.0, **kwargs):
        super().__init__(**kwargs)
        self.min_value = min_value
        self.max_value = max_value
        self.weights = (0.1, 0.2, 0.4)

    def compute(self, output: torch.Tensor, target: torch.Tensor,
                lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        if lengths is not None:
            mask = sequence_mask(lengths, output.shape[1])[..., None]
            output = torch.where(mask, output, output.new_tensor(self.min_value))
            target = torch.where(mask, target, target.new_tensor(self.min_value))
        rng = self.max_value - self.min_value
        x = torch.clamp((output - self.min_value) / rng, 0.0, 1.0)
        y = torch.clamp((target - self.min_value) / rng, 0.0, 1.0)
        total = x.new_tensor(1.0)
        for i, w in enumerate(self.weights):
            if min(x.shape[1], x.shape[2]) < 11:
                break
            ssim_map, cs_map = _ssim_2d(x, y)
            if i == len(self.weights) - 1:
                total = total * torch.clamp(ssim_map, min=0.0).mean() ** w
            else:
                total = total * torch.clamp(cs_map, min=0.0).mean() ** w
                x = F.avg_pool2d(x[:, None], 2)[:, 0]
                y = F.avg_pool2d(y[:, None], 2)[:, 0]
        return torch.clamp(1.0 - total, min=0.0)


class CTCLoss(BaseLoss):
    """CTC over (B, T, V) logits and (B, U) labels (``optax.ctc_loss``'s
    semantics): each sequence's negative log-likelihood over its label count
    (at least 1), then the batch mean. ``lengths`` bound the valid frames (all
    when None); ``target_lengths`` the valid labels (when None, the labels
    equal to ``blank_id`` are padding, which must trail)."""

    def __init__(self, blank_id: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.blank_id = blank_id

    def compute(self, output: torch.Tensor, target: torch.Tensor,
                lengths: tp.Optional[torch.Tensor] = None,
                target_lengths: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = output.shape
        if lengths is None:
            lengths = torch.full((b,), t, dtype=torch.long, device=output.device)
        if target_lengths is None:
            target_lengths = (target != self.blank_id).sum(-1)
        logp = F.log_softmax(output.float(), dim=-1).transpose(0, 1)
        per_seq = F.ctc_loss(logp, target.long(), lengths.long(), target_lengths.long(),
                             blank=self.blank_id, reduction="none")
        per_seq = per_seq / torch.clamp(target_lengths.to(per_seq.dtype), min=1.0)
        return per_seq.sum() / global_count(per_seq.new_tensor(float(b)))


LOSSES: tp.Dict[str, type] = {
    "Spectral": SpectralLoss,
    "Gate": GateLoss,
    "Regression": RegressionLoss,
    "Duration": DurationLoss,
    "VAE": VAELoss,
    "MLE": MLELoss,
    "GuidedAttention": GuidedAttentionLoss,
    "InverseSpeaker": InverseSpeakerLoss,
    "SoftDTW": SoftDTWLoss,
    "DiffSpectral": DiffSpectralLoss,
    "SSIM": SSIMLoss,
    "CTC": CTCLoss,
}


def build_loss(name: str, **kwargs) -> BaseLoss:
    """The zoo's loss ``name`` (a ``LOSSES`` key) built from ``kwargs`` (its own
    and the schedule's: scale, begin_iter, end_iter, every_iter, anneal_iters)."""
    return LOSSES[name](name=name, **kwargs)
