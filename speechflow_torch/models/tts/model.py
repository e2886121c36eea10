"""ParallelTTSModel, inference path (counterpart of
``speechflow_tpu/models/tts/model.py``).

Embedding (+ ling/LM/XPBERT projections) -> cond0 -> encoder -> cond1 ->
variance adaptor (predicted, rounded durations; hard length regulation) ->
cond2 -> decoder (CFM with batched CFG, or the wrapper decoder) -> postnet,
and the gate head. Training, style/prosody/average conditioning, the other
encoders and decoders wait for later slices: their flags raise here.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn as nn

from speechflow_torch.models.tts.common import ConditionalLayer, ConvStack
from speechflow_torch.models.tts.data_types import TTSForwardInput, TTSOutput
from speechflow_torch.models.tts.decoders import TTS_DECODERS, CFMDecoder
from speechflow_torch.models.tts.encoders import TTS_ENCODERS
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
    speaker_emb_mode: str = "table"
    lang_emb_dim: int = 32
    use_ling_feat: bool = False
    ling_feat_dim: int = 56
    use_lm_feat: bool = False
    lm_feat_dim: int = 32
    use_xpbert_feat: bool = False
    xpbert_feat_dim: int = 32
    use_prosody: bool = False
    use_average_emb: bool = False
    use_style_encoder: bool = False
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
        bad = [f for f in ("use_prosody", "use_average_emb", "use_style_encoder",
                           "soft_length_regulator", "use_inverse_speaker_classifier")
               if getattr(self, f)]
        if self.speaker_emb_mode != "table":
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

        self.speaker_emb = nn.Embedding(p.n_speakers, p.speaker_emb_dim)
        cond_dim = p.speaker_emb_dim
        if p.n_langs > 1:
            self.lang_emb = nn.Embedding(p.n_langs, p.lang_emb_dim)
            cond_dim += p.lang_emb_dim
        self.cond_dim = cond_dim

        self.conds = nn.ModuleDict()

        def make_cond(level: int, dim: int):
            if level in p.condition_levels:
                self.conds[f"level{level}"] = ConditionalLayer(p.condition_method, dim,
                                                               cond_dim)

        make_cond(0, content_dim)
        self.encoder = TTS_ENCODERS[p.encoder_type](
            dim_in=content_dim, dim_out=p.encoder_dim, dim=p.encoder_dim,
            n_layers=p.encoder_layers, n_heads=p.encoder_heads, cond_dim=cond_dim)
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
                                 n_layers=p.postnet_layers, kernel_size=5)
        if p.use_gate:
            self.gate_head = nn.Linear(p.n_mels, 1)

    def _cond(self, level: int, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        layer = self.conds[f"level{level}"] if f"level{level}" in self.conds else None
        return x if layer is None else layer(x, cond)

    def noise_shape(self, inputs: TTSForwardInput, t_out: int) -> tp.Tuple[int, int, int]:
        return (inputs.transcription.shape[0], t_out, self.p.n_mels)

    def forward(self, inputs: TTSForwardInput, training: bool = False,
                t_out: tp.Optional[int] = None,
                noise: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None) -> TTSOutput:
        """Inference. ``noise`` is the CFM's initial state (already scaled by
        the temperature); when None it is drawn from ``generator`` and scaled
        by ``decoder.temperature``."""
        if training:
            raise NotImplementedError("training is not ported yet")
        p = self.p
        tok_lens = inputs.transcription_lengths
        x = self.token_emb(inputs.transcription)
        if p.use_ling_feat and inputs.ling_feat is not None:
            x = x + self.ling_proj(inputs.ling_feat)
        if p.use_lm_feat and inputs.lm_feat is not None:
            x = x + self.lm_proj(inputs.lm_feat)
        if p.use_xpbert_feat and inputs.xpbert_feat is not None:
            x = x + self.xpbert_proj(inputs.xpbert_feat)

        parts = [self.speaker_emb(torch.clamp(inputs.speaker_id, min=0))]
        if p.n_langs > 1:
            parts.append(self.lang_emb(torch.clamp(inputs.lang_id, min=0)))
        cond = torch.cat(parts, dim=-1)

        x = self._cond(0, x, cond)
        x = self.encoder(x, tok_lens, cond)
        x = self._cond(1, x, cond)

        if t_out is None:
            t_out = inputs.mel.shape[1] if inputs.mel is not None else p.max_output_length
        x, out_lengths, var_preds, attn = self.variance_adaptor(
            x, tok_lens, inputs, t_out, training=False)
        x = self._cond(2, x, cond)

        extra: tp.Dict[str, torch.Tensor] = {}
        if isinstance(self.decoder, CFMDecoder):
            if noise is None:
                noise = torch.randn(self.noise_shape(inputs, t_out), generator=generator,
                                    device=x.device, dtype=torch.float32)
                noise = noise * self.decoder.temperature
            mu, dec_out = self.decoder.generate(x, out_lengths, cond, noise.to(x.dtype))
            extra["cfm_prior"] = mu
        else:
            dec_out = self.decoder(x, out_lengths, cond)

        post = dec_out + self.postnet(dec_out)
        post = apply_mask(post, sequence_mask(out_lengths, post.shape[1]))
        gate = self.gate_head(dec_out)[..., 0] if p.use_gate else None
        return TTSOutput(spectrogram=torch.stack([dec_out, post]),
                         spectrogram_lengths=out_lengths, gate=gate,
                         variance_predictions=var_preds, attention=attn,
                         additional_content=extra)
