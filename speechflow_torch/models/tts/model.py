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
(``style_eps`` gives the style sample's standard normal draw).
``use_average_emb`` bucket-embeds each named utterance average of
``inputs.averages`` (``averages``: name -> interval, n_bins, emb_dim,
log_scale; the interval's midpoint where the input lacks it) into the
condition. ``condition_sources`` replaces that concatenation with named
sources: the built-in speaker, lang and style embedders, ``average_<name>``,
or any input field (``condition_source_dims`` sizes it; a 3-D field is averaged
over its valid frames); ``<detach`` stops gradients through a source.
``use_inverse_speaker_classifier`` classifies the speaker from the time-averaged
postnet mel behind a gradient reversal (``inverse_speaker_logits`` in
``additional_content``, the criterion's cross-entropy). Every encoder of
``TTS_ENCODERS`` builds here (a ``VQEncoder``'s losses join
``additional_losses`` as ``encoder_*``, a multi-stream ``context`` encoder gets a
level-1 condition a stream), and so does every decoder: ``wrapper``, ``cfm``
and ``taco``, the Tacotron2 decoder over the regulated content (its gate replaces
the gate head's; ``prenet_masks`` gives its training call's dropout masks).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn as nn

from speechflow_torch.models.layers import flax_init_
from speechflow_torch.models.tts.ar_decoders import TacoDecoder
from speechflow_torch.models.tts.common import (
    ConditionalLayer,
    ConvStack,
    VarianceEmbedding,
    grad_reverse,
)
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
from speechflow_torch.utils.profiler import span

__all__ = ["ParallelTTSModel", "ParallelTTSParams"]


@dataclasses.dataclass
class ParallelTTSParams(BaseModelParams):
    # inputs
    n_symbols: int = 100
    n_langs: int = 1
    n_speakers: int = 1
    n_mels: int = 100
    max_input_length: int = 512
    max_output_length: int = 4096
    # embedding
    token_emb_dim: int = 256
    speaker_emb_dim: int = 128
    speaker_emb_mode: str = "table"     # table, else a projection of speaker_emb
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
    averages: dict = dataclasses.field(default_factory=dict)
    use_style_encoder: bool = False
    style_emb_dim: int = 128
    style_use_vae: bool = True
    style_use_gmvae: bool = False
    style_gmvae_components: int = 16
    # conditioning
    condition_method: str = "cat"
    condition_levels: tp.Tuple[int, ...] = (0, 2)
    condition_sources: tp.Tuple[str, ...] = ()
    condition_source_dims: dict = dataclasses.field(default_factory=dict)
    # stages
    encoder_type: str = "transformer"
    encoder_dim: int = 256
    encoder_layers: int = 4
    encoder_heads: int = 4
    use_remat: bool = False              # recompute each encoder block in the backward
    encoder_sub_types: tp.Tuple[str, ...] = ("cnn", "transformer")
    encoder_concat_streams: bool = True
    variances: tp.Tuple[dict, ...] = (
        {"name": "aggregate_pitch", "as_embedding": False},
        {"name": "aggregate_energy", "as_embedding": False},
        {"name": "durations"},
    )
    soft_length_regulator: bool = False
    decoder_type: str = "wrapper"        # wrapper | cfm | taco
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


class ParallelTTSModel(nn.Module):
    def __init__(self, params: ParallelTTSParams):
        super().__init__()
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
        if p.use_average_emb:
            self.average_embs = nn.ModuleDict({
                name: VarianceEmbedding(tuple(cfg.get("interval", (0.0, 1.0))),
                                        int(cfg.get("n_bins", 64)), int(cfg.get("emb_dim", 32)),
                                        log_scale=bool(cfg.get("log_scale", False)))
                for name, cfg in p.averages.items()})
            cond_dim += sum(int(cfg.get("emb_dim", 32)) for cfg in p.averages.values())
        if p.condition_sources:
            cond_dim = sum(self._source_dim(name) for name in p.condition_sources)
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
            dropout=p.dropout, use_remat=p.use_remat, sub_types=p.encoder_sub_types,
            concat=p.encoder_concat_streams, ling_feat_dim=p.ling_feat_dim,
            lm_feat_dim=p.lm_feat_dim)
        stream_dims = getattr(self.encoder, "stream_dims", None)
        if 1 in p.condition_levels and stream_dims is not None \
                and not p.encoder_concat_streams:
            for i, d in enumerate(stream_dims):
                self.conds[f"level1_stream{i}"] = ConditionalLayer(p.condition_method, d,
                                                                   cond_dim)
        else:
            make_cond(1, p.encoder_dim)

        self.variance_adaptor = HierarchicalVarianceAdaptor(
            getattr(self.encoder, "dim_out", p.encoder_dim),
            [VarianceConfig(**v) for v in p.variances],
            soft_length_regulator=p.soft_length_regulator,
            max_output_length=p.max_output_length)
        va_dim = self.variance_adaptor.dim_out
        make_cond(2, va_dim)

        if p.decoder_type == "cfm":
            self.decoder = CFMDecoder(dim_in=va_dim, dim_out=p.n_mels, dim=p.decoder_dim,
                                      n_layers=p.decoder_layers, n_heads=p.decoder_heads,
                                      cond_dim=cond_dim, n_timesteps=p.cfm_n_timesteps,
                                      cfg_scale=p.cfm_cfg_scale)
        elif p.decoder_type == "taco":
            self.decoder = TacoDecoder(dim_in=va_dim, dim_out=p.n_mels, dim=p.decoder_dim)
        else:
            self.decoder = TTS_DECODERS[p.decoder_type](
                dim_in=va_dim, dim_out=p.n_mels, inner=p.decoder_inner,
                dim=p.decoder_dim, n_layers=p.decoder_layers)
        make_cond(3, p.n_mels)

        self.postnet = ConvStack(p.n_mels, p.postnet_dim, p.n_mels,
                                 n_layers=p.postnet_layers, kernel_size=5, dropout=p.dropout)
        if p.use_gate:
            self.gate_head = nn.Linear(p.n_mels, 1)
        if p.use_inverse_speaker_classifier:
            self.inv_spk = nn.Linear(p.n_mels, p.n_speakers)
        flax_init_(self)

    def _source_dim(self, name: str) -> int:
        base = name.split("<", 1)[0]
        p = self.p
        known = {"speaker": p.speaker_emb_dim, "lang": p.lang_emb_dim,
                 "style": p.style_emb_dim, "speaker_emb": p.speaker_bio_dim,
                 "speech_quality_emb": 5}
        if base.startswith("average_") and base[len("average_"):] in p.averages:
            return int(p.averages[base[len("average_"):]].get("emb_dim", 32))
        if base in p.condition_source_dims:
            return int(p.condition_source_dims[base])
        if base in known:
            return known[base]
        raise ValueError(f"condition source '{base}' needs an entry in condition_source_dims")

    def _average_value(self, name: str, inputs: TTSForwardInput) -> torch.Tensor:
        """The (B,) value of one named average; absent (raw-text inference): the
        interval's midpoint."""
        if inputs.averages is not None and name in inputs.averages:
            return inputs.averages[name]
        lo, hi = self.p.averages[name].get("interval", (0.0, 1.0))
        return torch.full((inputs.transcription.shape[0],), (lo + hi) / 2.0,
                          dtype=torch.float32, device=inputs.transcription.device)

    def _speaker(self, inputs: TTSForwardInput) -> torch.Tensor:
        if self.p.speaker_emb_mode == "table":
            return self.speaker_emb(torch.clamp(inputs.speaker_id, min=0))
        if inputs.speaker_emb is None:
            raise ValueError(f"speaker_emb_mode={self.p.speaker_emb_mode!r} needs "
                             "inputs.speaker_emb")
        return self.speaker_proj(inputs.speaker_emb)

    def _style(self, inputs: TTSForwardInput, sample_style: bool,
               losses: tp.Dict[str, torch.Tensor], style_eps: tp.Optional[torch.Tensor],
               generator: tp.Optional[torch.Generator]) -> torch.Tensor:
        if inputs.mel is None:
            raise ValueError("the style encoder needs inputs.mel (a reference mel)")
        style, aux = self.style_encoder(inputs.mel, inputs.mel_lengths, not sample_style,
                                        eps=style_eps, generator=generator)
        if isinstance(aux, dict):  # the GMVAE's losses
            losses.update(aux)
        elif aux is not None:
            mu, logvar = aux
            losses["vae_kl"] = (-0.5 * (1 + logvar - mu ** 2 - torch.exp(logvar))).mean()
        return style

    def _lookup_condition(self, name: str, inputs: TTSForwardInput, *style_args
                          ) -> torch.Tensor:
        """One named source: a built-in embedder, ``average_<name>``, else an
        input field (3-D: averaged over ``<field>_lengths`` or, on the mel's time
        axis, ``mel_lengths``); ``<detach`` stops its gradient."""
        p = self.p
        base, *mods = name.split("<", 1)
        if base == "speaker":
            v = self._speaker(inputs)
        elif base == "lang":
            v = self.lang_emb(torch.clamp(inputs.lang_id, min=0))
        elif base == "style":
            v = self._style(inputs, *style_args)
        elif base.startswith("average_") and base[len("average_"):] in p.averages:
            avg = base[len("average_"):]
            v = self.average_embs[avg](self._average_value(avg, inputs))
        else:
            v = inputs.get(base)
            if v is None:
                raise ValueError(f"condition source '{base}' missing from inputs")
            if v.ndim == 3:
                lens = inputs.get(f"{base}_lengths")
                if lens is None and inputs.mel is not None and inputs.mel_lengths is not None \
                        and v.shape[1] == inputs.mel.shape[1]:
                    lens = inputs.mel_lengths
                if lens is not None:
                    m = sequence_mask(lens, v.shape[1])[..., None].to(v.dtype)
                    v = (v * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
                else:
                    v = v.mean(dim=1)
        if mods and "detach" in mods[0]:
            v = v.detach()
        return v

    def _global_condition(self, inputs: TTSForwardInput, sample_style: bool,
                          losses: tp.Dict[str, torch.Tensor],
                          style_eps: tp.Optional[torch.Tensor],
                          generator: tp.Optional[torch.Generator]) -> torch.Tensor:
        """The named sources, else speaker [+ language] [+ style] [+ averages]."""
        p = self.p
        style_args = (sample_style, losses, style_eps, generator)
        if p.condition_sources:
            parts = [self._lookup_condition(n, inputs, *style_args)
                     for n in p.condition_sources]
            return torch.cat(parts, dim=-1)
        parts = [self._speaker(inputs)]
        if p.n_langs > 1:
            parts.append(self.lang_emb(torch.clamp(inputs.lang_id, min=0)))
        if p.use_style_encoder:
            parts.append(self._style(inputs, *style_args))
        if p.use_average_emb:
            parts += [self.average_embs[name](self._average_value(name, inputs))
                      for name in p.averages]
        return torch.cat(parts, dim=-1)

    def _cond(self, level: int, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        layer = self.conds[f"level{level}"] if f"level{level}" in self.conds else None
        return x if layer is None else layer(x, cond)

    def noise_shape(self, inputs: TTSForwardInput, t_out: int) -> tp.Tuple[int, int, int]:
        return (inputs.transcription.shape[0], t_out, self.p.n_mels)

    def inference(self, inputs: TTSForwardInput, t_out: tp.Optional[int] = None,
                  cfm_timesteps: tp.Optional[int] = None,
                  noise: tp.Optional[torch.Tensor] = None,
                  generator: tp.Optional[torch.Generator] = None) -> TTSOutput:
        """The inference call, whatever the module's mode (JAX's entry the
        serving paths use): ``t_out`` frames, ``cfm_timesteps`` Euler steps,
        the CFM's initial state ``noise`` (scaled by the temperature) or drawn
        from ``generator``."""
        with span("tts.inference"):
            return self(inputs, training=False, t_out=t_out, noise=noise,
                        generator=generator, cfm_timesteps=cfm_timesteps)

    def forward(self, inputs: TTSForwardInput, training: tp.Optional[bool] = None,
                t_out: tp.Optional[int] = None,
                noise: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None,
                cfm_timesteps: tp.Optional[int] = None,
                deterministic: tp.Optional[bool] = None,
                cfm_draws: tp.Optional[CFMDraws] = None,
                style_eps: tp.Optional[torch.Tensor] = None,
                prenet_masks: tp.Optional[tp.Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> TTSOutput:
        """``training``: the teacher-forced call (None: ``self.training``),
        which needs ``inputs.mel``, ``mel_lengths`` and ``durations``.
        Inference: ``noise`` is the CFM's initial state (already scaled by the
        temperature); when None it is drawn from ``generator`` and scaled by
        ``decoder.temperature``; ``cfm_timesteps`` overrides the CFM's number
        of Euler steps. Training: ``cfm_draws`` are the CFM's u, z and CFG
        masks, else drawn from ``generator``; ``style_eps`` is the style VAE's
        standard normal draw (B, style_emb_dim) in the training call, else
        drawn from ``generator``; ``prenet_masks`` are the Tacotron decoder's
        two (T, B, 256) prenet dropout masks, else drawn from ``generator``."""
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
        extra: tp.Dict[str, torch.Tensor] = {}
        # the style VAE samples in the training call, whatever ``deterministic``
        # says, as the JAX model's does
        cond = self._global_condition(inputs, training, losses, style_eps, generator)

        x = self._cond(0, x, cond)
        enc_kwargs = {}
        if p.encoder_type == "sf":
            enc_kwargs = {"pitch": inputs.aggregate_pitch, "energy": inputs.aggregate_energy}
        elif p.encoder_type == "ling_condition":
            enc_kwargs = {"ling_feat": inputs.ling_feat, "lm_feat": inputs.lm_feat}
        x = self.encoder(x, tok_lens, cond, deterministic=det, **enc_kwargs)
        if hasattr(self.encoder, "pop_aux"):
            for k, v in self.encoder.pop_aux().items():
                (losses if k.endswith("_loss") else extra)[f"encoder_{k}"] = v
        if isinstance(x, list):
            if 1 in p.condition_levels:
                x = [self.conds[f"level1_stream{i}"](s, cond) for i, s in enumerate(x)]
        else:
            x = self._cond(1, x, cond)

        if t_out is None:
            t_out = inputs.mel.shape[1] if inputs.mel is not None else p.max_output_length
        x, out_lengths, var_preds, attn, va_losses = self.variance_adaptor(
            x, tok_lens, inputs, t_out, training=training, deterministic=det)
        losses.update(va_losses)
        if training:
            out_lengths = inputs.mel_lengths
        x = self._cond(2, x, cond)

        gate = None
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
        elif isinstance(self.decoder, TacoDecoder):
            # the training call drops in the prenet whatever ``deterministic`` says,
            # as JAX's does
            if training:
                dec_out, gate, extra["taco_attention"] = self.decoder(
                    x, out_lengths, inputs.mel, deterministic=False, masks=prenet_masks,
                    generator=generator)
            else:
                dec_out, gate = self.decoder.generate(x, out_lengths, max_frames=t_out)
        else:
            dec_out = self.decoder(x, out_lengths, cond, deterministic=det)

        post = dec_out + self.postnet(dec_out, det)
        post = apply_mask(post, sequence_mask(out_lengths, post.shape[1]))
        if p.use_gate and gate is None:
            gate = self.gate_head(dec_out)[..., 0]
        if p.use_inverse_speaker_classifier:
            extra["inverse_speaker_logits"] = self.inv_spk(grad_reverse(post).mean(dim=1))
        return TTSOutput(spectrogram=torch.stack([dec_out, post]),
                         spectrogram_lengths=out_lengths, gate=gate,
                         variance_predictions=var_preds, attention=attn,
                         additional_content=extra, additional_losses=losses)
