"""Vocoder GAN criteria (counterpart of
``speechflow_tpu/models/vocoder/criterion.py``): log-mel L1, multi-resolution
STFT, hinge adversarial and feature-matching losses, composed into the
generator and discriminator criteria ``GANTrainer`` calls as
``criterion(gen_out, disc, inputs, targets, step)``.

The adversarial gate reads ``step``, the trainer's micro-batch count: 0 before
``adv_start_iter``, then 1, or a linear ramp over ``adv_ramp_steps``. The
perceptual terms (``cpc_ckpt``, ``bio_ckpt``: the CPC model and the
speaker-similarity loss over an ECAPA embedder) are not ported: asking for one
raises ``NotImplementedError``.
``maximum`` against 0 (not ``relu``) keeps ``jnp.maximum``'s half gradient
at a tie.
"""

from __future__ import annotations

import typing as tp

import torch

from speechflow_torch.ops.mel import amp_to_db, linear_to_mel
from speechflow_torch.ops.stft import magnitude

__all__ = ["mel_reconstruction_loss", "multires_stft_loss", "vocoder_gen_criterion",
           "vocoder_disc_criterion"]


def _crop(fake: torch.Tensor, real: torch.Tensor):
    t = min(fake.shape[-1], real.shape[-1])
    return fake[..., :t], real[..., :t]


def mel_reconstruction_loss(fake: torch.Tensor, real: torch.Tensor, sample_rate: int = 24000,
                            n_fft: int = 1024, hop_length: int = 256,
                            n_mels: int = 100) -> torch.Tensor:
    fake, real = _crop(fake, real)

    def logmel(w):
        return amp_to_db(linear_to_mel(magnitude(w, n_fft, hop_length), sample_rate, n_mels))

    return torch.mean(torch.abs(logmel(fake) - logmel(real)))


def multires_stft_loss(fake: torch.Tensor, real: torch.Tensor,
                       resolutions=((512, 128), (1024, 256), (2048, 512))) -> torch.Tensor:
    fake, real = _crop(fake, real)
    total = 0.0
    for n_fft, hop in resolutions:
        mf = magnitude(fake, n_fft, hop)
        mr = magnitude(real, n_fft, hop)
        sc = torch.linalg.norm(mr - mf) / torch.clamp(torch.linalg.norm(mr), min=1e-6)
        lm = torch.mean(torch.abs(torch.log(mf + 1e-5) - torch.log(mr + 1e-5)))
        total = total + sc + lm
    return total / len(resolutions)


def _relu(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, x.new_zeros(()))


def _hinge_gen(logits: tp.Sequence[torch.Tensor]) -> torch.Tensor:
    return sum(torch.mean(_relu(1.0 - lg)) for lg in logits) / len(logits)


def _hinge_disc(real_logits, fake_logits) -> torch.Tensor:
    loss = 0.0
    for lr, lf in zip(real_logits, fake_logits):
        loss = loss + torch.mean(_relu(1.0 - lr)) + torch.mean(_relu(1.0 + lf))
    return loss / len(real_logits)


def _feature_matching(real_fmaps, fake_fmaps) -> torch.Tensor:
    loss, n = 0.0, 0
    for rf, ff in zip(real_fmaps, fake_fmaps):
        for r, f in zip(rf, ff):
            loss = loss + torch.mean(torch.abs(r - f))
            n += 1
    return loss / max(n, 1)


def vocoder_gen_criterion(sample_rate: int = 24000, n_mels: int = 100,
                          mel_weight: float = 45.0, fm_weight: float = 2.0,
                          stft_weight: float = 1.0, adv_weight: float = 1.0,
                          adv_start_iter: int = 0, adv_ramp_steps: int = 0,
                          cpc_ckpt: tp.Optional[str] = None, cpc_weight: float = 1.0,
                          bio_ckpt: tp.Optional[str] = None,
                          speaker_sim_weight: float = 1.0):
    if cpc_ckpt:
        raise NotImplementedError("cpc_ckpt: the CPC model (models/ssl) is not ported yet")
    if bio_ckpt:
        raise NotImplementedError("bio_ckpt: the speaker-similarity loss over an ECAPA "
                                  "embedder is not ported yet")

    def criterion(gen_out, disc, inputs, targets, step: int) -> tp.Dict[str, torch.Tensor]:
        fake, real = _crop(gen_out, targets["waveform"])
        losses = {
            "mel": mel_weight * mel_reconstruction_loss(fake, real, sample_rate,
                                                        n_mels=n_mels),
            "stft": stft_weight * multires_stft_loss(fake, real),
        }
        fake_logits, fake_fmaps = disc(fake)
        real_logits, real_fmaps = disc(real)
        gate = float(step >= adv_start_iter)
        if adv_ramp_steps > 0:
            gate *= min(max((step - adv_start_iter + 1) / adv_ramp_steps, 0.0), 1.0)
        losses["adv"] = adv_weight * gate * _hinge_gen(fake_logits)
        losses["fm"] = fm_weight * gate * _feature_matching(real_fmaps, fake_fmaps)
        return losses

    return criterion


def vocoder_disc_criterion():
    def criterion(gen_out, disc, inputs, targets, step: int) -> tp.Dict[str, torch.Tensor]:
        fake, real = _crop(gen_out, targets["waveform"])
        fake_logits, _ = disc(fake)
        real_logits, _ = disc(real)
        return {"disc_hinge": _hinge_disc(real_logits, fake_logits)}

    return criterion
