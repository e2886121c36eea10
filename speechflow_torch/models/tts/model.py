"""ParallelTTSModel (counterpart of ``speechflow_tpu/models/tts/model.py``).

Embedding (+ ling/LM/XPBERT projections) -> cond0 -> encoder -> cond1 ->
variance adaptor (hard length regulation) -> cond2 -> decoder (CFM with
batched CFG, or the wrapper decoder) -> postnet, and the gate head.

Two calls, chosen by ``training`` (by default the module's mode: a model in
``train()`` mode trains, one in ``eval()`` mode infers, so the generic
``Trainer``'s ``model(inputs)`` gets the training call and every serving
caller, which holds the model in eval mode, gets inference):

- inference: predicted, rounded durations over ``t_out`` frames, the CFM's
  Euler solve from the given or drawn noise;
- training (teacher-forced): the target durations, ``t_out`` = the mel's
  frames and the mel lengths as output lengths, the CFM's flow-matching loss
  (``CFMDecoder.forward_train``) in ``additional_losses`` and its prior as
  the decoder output.

``deterministic`` (default: not ``training``) switches dropout off apart from
teacher forcing, as the JAX model's argument does. The weights start from
flax's default initialisers (``flax_init_``), as the JAX model's do.

Conditioning: ``use_prosody`` adds an embedding of each token's prosody
class (``clip(prosody + 1, 0, n_prosody_classes)``: 0 is undefined) to the
token embedding; ``speaker_emb_mode="input"`` projects the input's
``speaker_emb`` (``speaker_bio_dim`` wide) in place of the speaker table;
``use_style_encoder`` encodes the input's ``mel`` (a reference mel at
inference) into a style vector that joins the condition, with its VAE's
``vae_kl`` or GMVAE's ``gmvae_gm`` / ``gmvae_cat`` in ``additional_losses``
(``style_eps`` gives the style sample's standard normal draw). Per-utterance
averages, named condition sources, the soft length regulator, the inverse
speaker classifier and the other encoders and decoders wait for later
slices: their flags raise here.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn as nn

from speechflow_torch.models.layers import flax_init_
from speechflow_torch.models.tts.common import ConditionalLayer, ConvStack
from speechflow_torch.models.tts.data_types import TTSForwardInput, TTSOutput
from speechflow_torch.models.tts.decoders import TTS_DECODERS, CFMDecoder, CFMDraws
from speechflow_torch.models.tts.encoders import TTS_ENCODERS
from speechflow_torch.models.tts.predictors import StyleEncoder
from speechflow_torch.models.tts.variance_adaptor import (
    HierarchicalVarianceAdaptor,
    VarianceConfig,
)
from speechflow_torch.training.base_model import BaseModelParams
from speechflow_torch.utils.masks import apply_mask, sequence_mask

__all__ = ["ParallelTTSModel", "ParallelTTSParams"]


@dataclasses.dataclass
class ParallelTTSParams(BaseModelParams):
    # inputs
    n_symbols: int = 100
    n_langs: int = 1
    n_speakers: int = 1
    n_mels: int = 100
    max_output_length: int = 4096
    # embedding
    token_emb_dim: int = 256
    speaker_emb_dim: int = 128
    speaker_emb_mode: str = "table"     # table | input (a projection of speaker_emb)
    speaker_bio_dim: int = 192
    lang_emb_dim: int = 32
    use_ling_feat: bool = False
    ling_feat_dim: int = 56
    use_lm_feat: bool = False
    lm_feat_dim: int = 32
    use_xpbert_feat: bool = False
    xpbert_feat_dim: int = 32
    use_prosody: bool = False
    n_prosody_classes: int = 16          # contour classes (+1 for undefined)
    use_average_emb: bool = False
    use_style_encoder: bool = False
    style_emb_dim: int = 128
    style_use_vae: bool = True
    style_use_gmvae: bool = False
    style_gmvae_components: int = 16
    # conditioning
    condition_method: str = "cat"
    condition_levels: tp.Tuple[int, ...] = (0, 2)
    condition_sources: tp.Tuple[str, ...] = ()
    # stages
    encoder_type: str = "transformer"
    encoder_dim: int = 256
    encoder_layers: int = 4
    encoder_heads: int = 4
    variances: tp.Tuple[dict, ...] = (
        {"name": "aggregate_pitch", "as_embedding": False},
        {"name": "aggregate_energy", "as_embedding": False},
        {"name": "durations"},
    )
    soft_length_regulator: bool = False
    decoder_type: str = "wrapper"
    decoder_dim: int = 256
    decoder_layers: int = 4
    decoder_heads: int = 4
    decoder_inner: str = "transformer"
    cfm_n_timesteps: int = 30
    cfm_cfg_scale: float = 0.0
    postnet_layers: int = 3
    postnet_dim: int = 256
    use_gate: bool = True
    use_inverse_speaker_classifier: bool = False
    dropout: float = 0.1

    def unported(self) -> tp.List[str]:
        bad = [f for f in ("use_average_emb", "soft_length_regulator",
                           "use_inverse_speaker_classifier")
               if getattr(self, f)]
        if self.speaker_emb_mode not in ("table", "input"):
            bad.append(f"speaker_emb_mode={self.speaker_emb_mode}")
        if self.condition_sources:
            bad.append("condition_sources")
        if self.encoder_type not in TTS_ENCODERS:
            bad.append(f"encoder_type={self.encoder_type}")
        if self.decoder_type not in TTS_DECODERS:
            bad.append(f"decoder_type={self.decoder_type}")
        return bad


class ParallelTTSModel(nn.Module):
    def __init__(self, params: ParallelTTSParams):
        super().__init__()
        bad = params.unported()
        if bad:
            raise NotImplementedError(f"not ported yet: {bad}")
        self.p = p = params

        self.token_emb = nn.Embedding(p.n_symbols, p.token_emb_dim)
        content_dim = p.token_emb_dim
        if p.use_ling_feat:
            self.ling_proj = nn.Linear(p.ling_feat_dim, p.token_emb_dim)
        if p.use_lm_feat:
            self.lm_proj = nn.Linear(p.lm_feat_dim, p.token_emb_dim)
        if p.use_xpbert_feat:
            self.xpbert_proj = nn.Linear(p.xpbert_feat_dim, p.token_emb_dim)
        if p.use_prosody:
            self.prosody_emb = nn.Embedding(p.n_prosody_classes + 1, p.token_emb_dim)

        if p.speaker_emb_mode == "table":
            self.speaker_emb = nn.Embedding(p.n_speakers, p.speaker_emb_dim)
        else:
            self.speaker_proj = nn.Linear(p.speaker_bio_dim, p.speaker_emb_dim)
        cond_dim = p.speaker_emb_dim
        if p.n_langs > 1:
            self.lang_emb = nn.Embedding(p.n_langs, p.lang_emb_dim)
            cond_dim += p.lang_emb_dim
        if p.use_style_encoder:
            self.style_encoder = StyleEncoder(
                p.n_mels, emb_dim=p.style_emb_dim, use_vae=p.style_use_vae,
                use_gmvae=p.style_use_gmvae, gmvae_n_components=p.style_gmvae_components)
            cond_dim += p.style_emb_dim
        self.cond_dim = cond_dim

        self.conds = nn.ModuleDict()

        def make_cond(level: int, dim: int):
            if level in p.condition_levels:
                self.conds[f"level{level}"] = ConditionalLayer(p.condition_method, dim,
                                                               cond_dim)

        make_cond(0, content_dim)
        self.encoder = TTS_ENCODERS[p.encoder_type](
            dim_in=content_dim, dim_out=p.encoder_dim, dim=p.encoder_dim,
            n_layers=p.encoder_layers, n_heads=p.encoder_heads, cond_dim=cond_dim,
            dropout=p.dropout)
        make_cond(1, p.encoder_dim)

        self.variance_adaptor = HierarchicalVarianceAdaptor(
            p.encoder_dim, [VarianceConfig(**v) for v in p.variances],
            max_output_length=p.max_output_length)
        va_dim = self.variance_adaptor.dim_out
        make_cond(2, va_dim)

        if p.decoder_type == "cfm":
            self.decoder = CFMDecoder(dim_in=va_dim, dim_out=p.n_mels, dim=p.decoder_dim,
                                      n_layers=p.decoder_layers, n_heads=p.decoder_heads,
                                      cond_dim=cond_dim, n_timesteps=p.cfm_n_timesteps,
                                      cfg_scale=p.cfm_cfg_scale)
        else:
            self.decoder = TTS_DECODERS[p.decoder_type](
                dim_in=va_dim, dim_out=p.n_mels, inner=p.decoder_inner,
                dim=p.decoder_dim, n_layers=p.decoder_layers)
        make_cond(3, p.n_mels)

        self.postnet = ConvStack(p.n_mels, p.postnet_dim, p.n_mels,
                                 n_layers=p.postnet_layers, kernel_size=5, dropout=p.dropout)
        if p.use_gate:
            self.gate_head = nn.Linear(p.n_mels, 1)
        flax_init_(self)

    def _global_condition(self, inputs: TTSForwardInput, sample_style: bool,
                          losses: tp.Dict[str, torch.Tensor],
                          style_eps: tp.Optional[torch.Tensor],
                          generator: tp.Optional[torch.Generator]) -> torch.Tensor:
        """speaker (table row or projected ``speaker_emb``) [+ language] [+ style]."""
        p = self.p
        if p.speaker_emb_mode == "table":
            parts = [self.speaker_emb(torch.clamp(inputs.speaker_id, min=0))]
        else:
            if inputs.speaker_emb is None:
                raise ValueError("speaker_emb_mode='input' needs inputs.speaker_emb")
            parts = [self.speaker_proj(inputs.speaker_emb)]
        if p.n_langs > 1:
            parts.append(self.lang_emb(torch.clamp(inputs.lang_id, min=0)))
        if p.use_style_encoder:
            if inputs.mel is None:
                raise ValueError("the style encoder needs inputs.mel (a reference mel)")
            style, aux = self.style_encoder(inputs.mel, inputs.mel_lengths,
                                            not sample_style, eps=style_eps,
                                            generator=generator)
            parts.append(style)
            if isinstance(aux, dict):  # the GMVAE's losses
                losses.update(aux)
            elif aux is not None:
                mu, logvar = aux
                losses["vae_kl"] = (-0.5 * (1 + logvar - mu ** 2 - torch.exp(logvar))).mean()
        return torch.cat(parts, dim=-1)

    def _cond(self, level: int, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        layer = self.conds[f"level{level}"] if f"level{level}" in self.conds else None
        return x if layer is None else layer(x, cond)

    def noise_shape(self, inputs: TTSForwardInput, t_out: int) -> tp.Tuple[int, int, int]:
        return (inputs.transcription.shape[0], t_out, self.p.n_mels)

    def forward(self, inputs: TTSForwardInput, training: tp.Optional[bool] = None,
                t_out: tp.Optional[int] = None,
                noise: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None,
                cfm_timesteps: tp.Optional[int] = None,
                deterministic: tp.Optional[bool] = None,
                cfm_draws: tp.Optional[CFMDraws] = None,
                style_eps: tp.Optional[torch.Tensor] = None) -> TTSOutput:
        """``training``: the teacher-forced call (None: ``self.training``),
        which needs ``inputs.mel``, ``mel_lengths`` and ``durations``.
        Inference: ``noise`` is the CFM's initial state (already scaled by the
        temperature); when None it is drawn from ``generator`` and scaled by
        ``decoder.temperature``; ``cfm_timesteps`` overrides the CFM's number
        of Euler steps. Training: ``cfm_draws`` are the CFM's u, z and CFG
        masks, else drawn from ``generator``; ``style_eps`` is the style VAE's
        standard normal draw (B, style_emb_dim) in the training call, else
        drawn from ``generator``."""
        training = self.training if training is None else training
        det = (not training) if deterministic is None else deterministic
        p = self.p
        if training and (inputs.mel is None or inputs.mel_lengths is None):
            raise ValueError("the training call needs inputs.mel and mel_lengths "
                             "(a model in train() mode trains: call eval() to infer)")
        tok_lens = inputs.transcription_lengths
        x = self.token_emb(inputs.transcription)
        if p.use_ling_feat and inputs.ling_feat is not None:
            x = x + self.ling_proj(inputs.ling_feat)
        if p.use_lm_feat and inputs.lm_feat is not None:
            x = x + self.lm_proj(inputs.lm_feat)
        if p.use_xpbert_feat and inputs.xpbert_feat is not None:
            x = x + self.xpbert_proj(inputs.xpbert_feat)
        if p.use_prosody and inputs.prosody is not None:
            x = x + self.prosody_emb(torch.clamp(inputs.prosody.long() + 1, 0,
                                                 p.n_prosody_classes))

        losses: tp.Dict[str, torch.Tensor] = {}
        # the style VAE samples in the training call, whatever ``deterministic``
        # says, as the JAX model's does
        cond = self._global_condition(inputs, training, losses, style_eps, generator)

        x = self._cond(0, x, cond)
        x = self.encoder(x, tok_lens, cond, deterministic=det)
        x = self._cond(1, x, cond)

        if t_out is None:
            t_out = inputs.mel.shape[1] if inputs.mel is not None else p.max_output_length
        x, out_lengths, var_preds, attn = self.variance_adaptor(
            x, tok_lens, inputs, t_out, training=training, deterministic=det)
        if training:
            out_lengths = inputs.mel_lengths
        x = self._cond(2, x, cond)

        extra: tp.Dict[str, torch.Tensor] = {}
        if isinstance(self.decoder, CFMDecoder):
            if training:
                dec_out, cfm_losses = self.decoder.forward_train(
                    x, out_lengths, inputs.mel.to(x.dtype), cond, draws=cfm_draws,
                    generator=generator)
                losses.update(cfm_losses)
            else:
                if noise is None:
                    noise = torch.randn(self.noise_shape(inputs, t_out), generator=generator,
                                        device=x.device, dtype=torch.float32)
                    noise = noise * self.decoder.temperature
                mu, dec_out = self.decoder.generate(x, out_lengths, cond, noise.to(x.dtype),
                                                    n_timesteps=cfm_timesteps)
                extra["cfm_prior"] = mu
        else:
            dec_out = self.decoder(x, out_lengths, cond, deterministic=det)

        post = dec_out + self.postnet(dec_out, det)
        post = apply_mask(post, sequence_mask(out_lengths, post.shape[1]))
        gate = self.gate_head(dec_out)[..., 0] if p.use_gate else None
        return TTSOutput(spectrogram=torch.stack([dec_out, post]),
                         spectrogram_lengths=out_lengths, gate=gate,
                         variance_predictions=var_preds, attention=attn,
                         additional_content=extra, additional_losses=losses)
