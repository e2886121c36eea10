"""Vocoder GAN criteria (counterpart of
``speechflow_tpu/models/vocoder/criterion.py``): log-mel L1, multi-resolution
STFT, hinge adversarial and feature-matching losses, composed into the
generator and discriminator criteria ``GANTrainer`` calls as
``criterion(gen_out, disc, inputs, targets, step)``.

The adversarial gate reads ``step``, the trainer's micro-batch count: 0 before
``adv_start_iter``, then 1, or a linear ramp over ``adv_ramp_steps``.
``bio_ckpt`` adds the speaker-similarity loss (``make_speaker_similarity_loss``,
1 - cosine of a frozen ECAPA's embeddings). A generator output
``(wav, ft_losses)`` (the ``codec`` and ``tts`` extractors) has its losses
merged into the generator's and its waveform alone judged. ``cpc_ckpt`` adds
the CPC perceptual loss (``make_cpc_perceptual_loss``, the L1 between a frozen
CPC's features of the two waveforms).
``maximum`` against 0 (not ``relu``) keeps ``jnp.maximum``'s half gradient
at a tie.
"""

from __future__ import annotations

import typing as tp

import torch

from speechflow_torch.models.vocoder.model import split_output
from speechflow_torch.ops.mel import amp_to_db, linear_to_mel
from speechflow_torch.ops.stft import magnitude
from speechflow_torch.parallel.distributed import norm_ratio

__all__ = ["mel_reconstruction_loss", "multires_stft_loss", "make_cpc_perceptual_loss",
           "make_speaker_similarity_loss", "vocoder_gen_criterion", "vocoder_disc_criterion"]


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
        sc = norm_ratio(mr - mf, mr)
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


def make_cpc_perceptual_loss(cpc_ckpt, device: tp.Union[str, torch.device, None] = None
                              ) -> tp.Callable:
    """``loss(fake, real)``: the mean L1 between the features of the CPC of
    ``cpc_ckpt`` (a ``save_module`` pickle of either package, frozen, on
    ``device``: the GPU unless ``device="cpu"``) of the two waveforms. The
    real side carries no gradient; the fake side's flows back through the
    frozen CPC into the waveform. The CPC runs in float32 with autocast off,
    as JAX's, whose mixed precision sets the compute dtype of the generator
    and the discriminator only."""
    from speechflow_torch.models.ssl import CPCModel, CPCParams
    from speechflow_torch.utils.state_io import load_module

    model, _ = load_module(CPCModel, CPCParams, cpc_ckpt, device=device)
    model.requires_grad_(False)

    def features(wav: torch.Tensor) -> torch.Tensor:
        with torch.autocast(wav.device.type, enabled=False):
            return model(wav.float())

    def loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            r = features(real)
        return torch.mean(torch.abs(features(fake) - r))

    loss.model = model
    return loss


def make_speaker_similarity_loss(bio_ckpt, sample_rate: int = 24000, n_fft: int = 1024,
                                 hop: int = 256,
                                 device: tp.Union[str, torch.device, None] = None
                                 ) -> tp.Callable:
    """``loss(fake, real)``: the mean over the batch of 1 - cosine between the
    ECAPA embeddings of the two waveforms' log-mels (the ECAPA of
    ``bio_ckpt``, a ``save_module`` pickle of either package, frozen, on
    ``device``: the GPU unless ``device="cpu"``). The real side is detached."""
    from speechflow_torch.models.biometric.ecapa import ECAPAEmbedder, ECAPAParams
    from speechflow_torch.utils.state_io import load_module

    model, params = load_module(ECAPAEmbedder, ECAPAParams, bio_ckpt, device=device)
    model.requires_grad_(False)
    n_mels = params.n_mels

    def embed(wav):
        mel = amp_to_db(linear_to_mel(magnitude(wav, n_fft, hop), sample_rate, n_mels))
        emb = model(mel)
        return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-9)

    def loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
        e_f = embed(fake)
        e_r = embed(real).detach()
        return torch.mean(1.0 - torch.sum(e_f * e_r, dim=-1))

    return loss


def vocoder_gen_criterion(sample_rate: int = 24000, n_mels: int = 100,
                          mel_weight: float = 45.0, fm_weight: float = 2.0,
                          stft_weight: float = 1.0, adv_weight: float = 1.0,
                          adv_start_iter: int = 0, adv_ramp_steps: int = 0,
                          cpc_ckpt: tp.Optional[str] = None, cpc_weight: float = 1.0,
                          bio_ckpt: tp.Optional[str] = None,
                          speaker_sim_weight: float = 1.0,
                          device: tp.Union[str, torch.device, None] = None):
    """``device`` is where the ``cpc_ckpt`` CPC and the ``bio_ckpt`` ECAPA run
    (the GPU unless ``device="cpu"``)."""
    cpc_loss = make_cpc_perceptual_loss(cpc_ckpt, device=device) if cpc_ckpt else None
    spk_loss = (make_speaker_similarity_loss(bio_ckpt, sample_rate, device=device)
                if bio_ckpt else None)

    def criterion(gen_out, disc, inputs, targets, step: int) -> tp.Dict[str, torch.Tensor]:
        gen_out, ft_losses = split_output(gen_out)
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
        if cpc_loss is not None:
            losses["cpc"] = cpc_weight * cpc_loss(fake, real)
        if spk_loss is not None:
            losses["spk_sim"] = speaker_sim_weight * spk_loss(fake, real)
        losses.update(ft_losses)
        return losses

    return criterion


def vocoder_disc_criterion():
    def criterion(gen_out, disc, inputs, targets, step: int) -> tp.Dict[str, torch.Tensor]:
        fake, real = _crop(split_output(gen_out)[0], targets["waveform"])
        fake_logits, _ = disc(fake)
        real_logits, _ = disc(real)
        return {"disc_hinge": _hinge_disc(real_logits, fake_logits)}

    return criterion
