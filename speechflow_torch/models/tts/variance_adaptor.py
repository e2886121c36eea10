"""Hierarchical variance adaptor (counterpart of
``speechflow_tpu/models/tts/variance_adaptor.py``).

Variances other than ``durations`` are predicted per token from their input
stream and condition the content, in order: their raw value is concatenated
(``as_embedding``: its ``VarianceEmbedding``) to the streams ``cat_to_streams``
names (by default the input stream). ``durations`` then drive the length
regulation of every stream (hard, or the soft Gaussian regulator), and the
streams are concatenated. At inference (``training=False``) durations are
predicted and rounded, and a predicted value conditions the content detached
from the graph; with ``training=True`` and given targets, the targets are used
as they are. A variance with ``detach_input`` feeds its predictor the content
detached. Each predictor drops at its own ``VarianceConfig.dropout`` (the
duration predictor at its default 0.1) when ``deterministic`` is False. The
SSML modifiers of the inputs multiply the pitch and energy values
(``pitch_modifier``, ``volume_modifier``), and predicted durations are divided
by ``max(rate_modifier, 1e-3)`` before they are rounded.

``use_discriminator`` adds a ``SignalDiscriminator`` whose LSGAN losses
(``<name>_disc_loss``, ``<name>_gen_loss``) the training call returns;
``use_gradtts_fa`` replaces the duration predictor with ``GradTTSFA``: its
monotonic-alignment durations regulate the training call (``durations_fa`` in
the predictions, ``fa_duration`` and ``fa_prior`` in the losses) and its own
predictor the inference call.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn as nn

from speechflow_torch.models.tts.common import VarianceEmbedding
from speechflow_torch.models.tts.predictors import (
    GradTTSFA,
    SignalDiscriminator,
    TokenLevelDP,
    VariancePredictor,
)
from speechflow_torch.ops.length_regulator import length_regulate_hard, length_regulate_soft

__all__ = ["VarianceConfig", "HierarchicalVarianceAdaptor"]


@dataclasses.dataclass
class VarianceConfig:
    name: str
    target: tp.Optional[str] = None
    dim: int = 256
    n_layers: int = 3
    kernel_size: int = 5
    dropout: float = 0.1          # the variance predictor's, not the duration predictor's
    use_target: bool = True
    detach_input: bool = False
    as_embedding: bool = False
    interval: tp.Tuple[float, float] = (0.0, 880.0)
    n_bins: int = 256
    emb_dim: int = 64
    cat_to_content: bool = True
    log_scale_embedding: bool = False
    use_discriminator: bool = False
    disc_dim: int = 192
    use_gradtts_fa: bool = False
    fa_feat_dim: int = 100
    fa_dim: int = 256
    input_stream: int = 0
    cat_to_streams: tp.Optional[tp.Tuple[int, ...]] = None  # default: (input_stream,)


class HierarchicalVarianceAdaptor(nn.Module):
    def __init__(self, dim: tp.Union[int, tp.Sequence[int]],
                 variances: tp.Sequence[VarianceConfig], soft_length_regulator: bool = False,
                 max_output_length: int = 4096):
        super().__init__()
        self.variances = list(variances)
        self.soft_lr = soft_length_regulator
        self.max_output_length = max_output_length
        dims = list(dim) if isinstance(dim, (list, tuple)) else [int(dim)]
        self.n_streams = len(dims)
        self.predictors = nn.ModuleDict()
        self.embeddings = nn.ModuleDict()
        self.discriminators = nn.ModuleDict()
        cur = dims[:]
        for v in self.variances:
            s = min(v.input_stream, self.n_streams - 1)
            if v.name == "durations":
                self.predictors[v.name] = (GradTTSFA(cur[s], v.fa_feat_dim, v.fa_dim)
                                           if v.use_gradtts_fa else TokenLevelDP(cur[s], v.dim))
                continue
            self.predictors[v.name] = VariancePredictor(cur[s], v.dim, v.n_layers,
                                                        v.kernel_size, v.dropout)
            if v.use_discriminator:
                self.discriminators[v.name] = SignalDiscriminator(cur[s], v.disc_dim)
            if v.cat_to_content:
                feat_dim = 1
                if v.as_embedding:
                    self.embeddings[v.name] = VarianceEmbedding(
                        v.interval, v.n_bins, v.emb_dim, log_scale=v.log_scale_embedding)
                    feat_dim = v.emb_dim
                for t in self._targets(v, s):
                    cur[t] += feat_dim
        self.dim_out = sum(cur)

    def _targets(self, v: VarianceConfig, s: int) -> tp.List[int]:
        return [min(t, self.n_streams - 1) for t in (v.cat_to_streams or (s,))]

    def forward(self, content, token_lengths: torch.Tensor, inputs, t_out: int,
                training: bool = False, deterministic: bool = True):
        """Returns (content (B, t_out, dim_out), out_lengths, predictions, attn,
        losses)."""
        predictions: tp.Dict[str, torch.Tensor] = {}
        losses: tp.Dict[str, torch.Tensor] = {}
        streams = list(content) if isinstance(content, (list, tuple)) else [content]
        n = len(streams)
        modifiers = {"aggregate_pitch": inputs.get("pitch_modifier"),
                     "aggregate_energy": inputs.get("volume_modifier")}
        for v in self.variances:
            if v.name == "durations":
                continue
            s = min(v.input_stream, n - 1)
            inp = streams[s].detach() if v.detach_input else streams[s]
            pred = self.predictors[v.name](inp, token_lengths, deterministic)
            predictions[v.name] = pred
            target = inputs.get(v.target or v.name)
            if v.use_discriminator and training and target is not None:
                d_losses = self.discriminators[v.name].lsgan_losses(inp, target, pred,
                                                                    token_lengths)
                losses.update({f"{v.name}_{k}": lv for k, lv in d_losses.items()})
            value = target if (training and v.use_target and target is not None) \
                else pred.detach()
            mod = modifiers.get(v.name)
            if mod is not None:
                value = value * mod.to(value.dtype)
            if v.cat_to_content:
                feat = (self.embeddings[v.name](value) if v.as_embedding
                        else value[..., None])
                for t in self._targets(v, s):
                    streams[t] = torch.cat([streams[t], feat.to(streams[t].dtype)], dim=-1)

        dur_cfg = next((v for v in self.variances if v.name == "durations"), None)
        attn = None
        out_lengths = token_lengths
        if dur_cfg is not None:
            ds = min(dur_cfg.input_stream, n - 1)
            dur_in = streams[ds].detach() if dur_cfg.detach_input else streams[ds]
            rate = inputs.get("rate_modifier")
            if dur_cfg.use_gradtts_fa:
                fa = self.predictors["durations"]
                mel = inputs.get("mel")
                if training and mel is not None:
                    durations, _, fa_losses = fa.align(dur_in, token_lengths, mel,
                                                       inputs.get("mel_lengths"),
                                                       deterministic=deterministic)
                    losses.update(fa_losses)
                    predictions["durations_fa"] = durations
                else:
                    durations = fa.predict(dur_in, token_lengths, deterministic)
                    if rate is not None:
                        durations = durations / torch.clamp(rate.float(), min=1e-3)
                    durations = torch.round(durations)
            else:
                log_d = self.predictors["durations"](dur_in, token_lengths, deterministic)
                predictions["durations"] = log_d
                target_d = inputs.get("durations")
                if training and dur_cfg.use_target and target_d is not None:
                    durations = target_d
                else:
                    durations = TokenLevelDP.to_durations(log_d.float(), token_lengths)
                    if rate is not None:  # SSML rate: slower speech, longer tokens
                        durations = durations / torch.clamp(rate.float(), min=1e-3)
                    durations = torch.round(durations)
            regulate = length_regulate_soft if self.soft_lr else length_regulate_hard
            for i in range(n):
                streams[i], attn = regulate(streams[i], durations, t_out)
            out_lengths = torch.clamp(durations.sum(dim=-1), 1, t_out).to(torch.int32)
        x = streams[0] if n == 1 else torch.cat(streams, dim=-1)
        return x, out_lengths, predictions, attn, losses
