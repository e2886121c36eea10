"""Hierarchical variance adaptor (counterpart of
``speechflow_tpu/models/tts/variance_adaptor.py``).

The slice's form: raw-value variances (pitch, energy, ...) are predicted per
token and concatenated to the content in order; ``durations`` drive hard
length regulation. At inference (``training=False``) durations are predicted
and rounded, and a predicted value conditions the content detached from the
graph; with ``training=True`` and given targets, the targets are used as
they are (the teacher-forced branch). A variance with ``detach_input`` feeds
its predictor the content detached. Each predictor drops at its own
``VarianceConfig.dropout`` (the duration predictor at its default 0.1, as
the JAX adaptor builds it) when ``deterministic`` is False. The SSML
modifiers of the inputs multiply the pitch and energy values
(``pitch_modifier``, ``volume_modifier``), and predicted durations are
divided by ``max(rate_modifier, 1e-3)`` before they are rounded. Variance
embeddings, discriminators, the in-model aligner, multi-stream routing and
the soft regulator wait for a later slice; their config flags raise here.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn as nn

from speechflow_torch.models.tts.predictors import TokenLevelDP, VariancePredictor
from speechflow_torch.ops.length_regulator import length_regulate_hard

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
    cat_to_content: bool = True
    # not ported yet: each raises when set
    as_embedding: bool = False
    use_discriminator: bool = False
    use_gradtts_fa: bool = False
    input_stream: int = 0
    cat_to_streams: tp.Optional[tp.Tuple[int, ...]] = None

    def __post_init__(self):
        unported = [f for f in ("as_embedding", "use_discriminator", "use_gradtts_fa")
                    if getattr(self, f)]
        if unported or self.input_stream or self.cat_to_streams:
            raise NotImplementedError(
                f"variance {self.name}: {unported or 'multi-stream routing'} "
                "is not ported yet")


class HierarchicalVarianceAdaptor(nn.Module):
    def __init__(self, dim: int, variances: tp.Sequence[VarianceConfig],
                 max_output_length: int = 4096):
        super().__init__()
        self.variances = list(variances)
        self.max_output_length = max_output_length
        self.predictors = nn.ModuleDict()
        cur = dim
        for v in self.variances:
            if v.name == "durations":
                self.predictors[v.name] = TokenLevelDP(cur, v.dim)
            else:
                self.predictors[v.name] = VariancePredictor(cur, v.dim, v.n_layers,
                                                            v.kernel_size, v.dropout)
                if v.cat_to_content:
                    cur += 1
        self.dim_out = cur

    def forward(self, content: torch.Tensor, token_lengths: torch.Tensor, inputs,
                t_out: int, training: bool = False, deterministic: bool = True):
        """Returns (content (B, t_out, dim_out), out_lengths, predictions, attn)."""
        predictions: tp.Dict[str, torch.Tensor] = {}
        # SSML modifiers multiply the conditioning values
        modifiers = {"aggregate_pitch": inputs.get("pitch_modifier"),
                     "aggregate_energy": inputs.get("volume_modifier")}
        x = content
        for v in self.variances:
            if v.name == "durations":
                continue
            inp = x.detach() if v.detach_input else x
            pred = self.predictors[v.name](inp, token_lengths, deterministic)
            predictions[v.name] = pred
            target = inputs.get(v.target or v.name)
            value = target if (training and v.use_target and target is not None) \
                else pred.detach()
            mod = modifiers.get(v.name)
            if mod is not None:
                value = value * mod.to(value.dtype)
            if v.cat_to_content:
                x = torch.cat([x, value[..., None].to(x.dtype)], dim=-1)

        dur_cfg = next((v for v in self.variances if v.name == "durations"), None)
        attn = None
        out_lengths = token_lengths
        if dur_cfg is not None:
            dur_in = x.detach() if dur_cfg.detach_input else x
            log_d = self.predictors["durations"](dur_in, token_lengths, deterministic)
            predictions["durations"] = log_d
            target_d = inputs.get("durations")
            if training and dur_cfg.use_target and target_d is not None:
                durations = target_d
            else:
                durations = TokenLevelDP.to_durations(log_d.float(), token_lengths)
                rate = inputs.get("rate_modifier")
                if rate is not None:  # SSML rate: slower speech, longer tokens
                    durations = durations / torch.clamp(rate.float(), min=1e-3)
                durations = torch.round(durations)
            x, attn = length_regulate_hard(x, durations, t_out)
            out_lengths = torch.clamp(durations.sum(dim=-1), 1, t_out).to(torch.int32)
        return x, out_lengths, predictions, attn
