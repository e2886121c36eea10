"""Plain reference of the flagship acoustic model's inference call.

Embeddings of tokens and of the ling/LM/XPBERT features -> a "cat" condition
(speaker and language tables) -> a pre-LN transformer encoder with RoPE ->
the pitch and energy predictors, whose predictions join the content ->
the duration predictor in the log(1 + d) domain, rounded durations and the
hard length regulator -> the condition again -> a CFM decoder: a prior
projection and a fixed-step Euler solve over the cosine time grid of an
AdaLN DiT estimator, with batched classifier-free guidance -> a conv postnet.

Parameter names are the program's (``ParallelTTSModel``'s state dict), so one
set of weights made by the benchmark loads into both; the modules here only
hold the parameters, and every computation is ``reference.nn``'s. Only the
options the configuration uses are built; any other raises.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference import nn as R


def _cfg_check(cfg: dict) -> None:
    need = {"encoder_type": "transformer", "decoder_type": "cfm", "condition_method": "cat",
            "speaker_emb_mode": "table"}
    for k, v in need.items():
        if cfg.get(k, v) != v:
            raise ValueError(f"the reference builds {k}={v!r} only, not {cfg[k]!r}")
    if tuple(cfg.get("condition_levels", (0, 2))) != (0, 2):
        raise ValueError("the reference builds condition levels (0, 2) only")
    names = [v["name"] for v in cfg["variances"]]
    if names != ["aggregate_pitch", "aggregate_energy", "durations"]:
        raise ValueError(f"the reference builds the variances pitch, energy, durations: {names}")
    for flag in ("use_prosody", "use_style_encoder", "use_average_emb", "soft_length_regulator",
                 "use_inverse_speaker_classifier"):
        if cfg.get(flag):
            raise ValueError(f"the reference does not build {flag}")


class ConvBlock(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, k: int):
        super().__init__()
        self.conv = nn.Conv1d(dim_in, dim_out, k)
        self.norm = nn.LayerNorm(dim_out)

    def __call__(self, x, prec):
        h = R.conv1d(x, self.conv.weight, self.conv.bias, prec)
        return F.relu(R.layer_norm(h, self.norm.weight, self.norm.bias, prec))


class ConvStack(nn.Module):
    def __init__(self, dim_in: int, dim: int, dim_out: int, n_layers: int, k: int):
        super().__init__()
        dims = [dim_in] + [dim] * (n_layers - 1) + [dim_out]
        self.blocks = nn.ModuleList(ConvBlock(dims[i], dims[i + 1], k) for i in range(n_layers))

    def __call__(self, x, prec):
        for blk in self.blocks:
            x = blk(x, prec)
        return x


class Predictor(nn.Module):
    """Conv stack and a scalar projection, masked to the tokens."""

    def __init__(self, dim_in: int, dim: int, n_layers: int, k: int):
        super().__init__()
        self.stack = ConvStack(dim_in, dim, dim, n_layers, k)
        self.out = nn.Linear(dim, 1)

    def __call__(self, x, lengths, prec):
        v = R.linear(self.stack(x, prec), self.out.weight, self.out.bias, prec)[..., 0]
        return v * R.seq_mask(lengths, v.shape[1]).to(v.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value, self.out = (nn.Linear(dim, dim) for _ in range(4))

    def __call__(self, x, valid, prec):
        b, t, d = x.shape
        shape = (b, t, self.heads, d // self.heads)
        q, k, v = (R.linear(x, m.weight, m.bias, prec).view(shape)
                   for m in (self.query, self.key, self.value))
        o = R.attention(q, k, v, valid, prec).reshape(b, t, d)
        return R.linear(o, self.out.weight, self.out.bias, prec)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.ffn1 = nn.Linear(dim, 4 * dim)
        self.ffn2 = nn.Linear(4 * dim, dim)

    def __call__(self, x, valid, prec):
        h = R.rope(R.layer_norm(x, self.norm1.weight, self.norm1.bias, prec))
        x = x + self.attn(h, valid, prec)
        h = R.layer_norm(x, self.norm2.weight, self.norm2.bias, prec)
        h = R.linear(R.gelu(R.linear(h, self.ffn1.weight, self.ffn1.bias, prec)),
                     self.ffn2.weight, self.ffn2.bias, prec)
        return x + h


class DiTBlock(nn.Module):
    def __init__(self, dim: int, cond_dim: int, heads: int):
        super().__init__()
        self.mod = nn.Linear(cond_dim, 6 * dim)
        self.attn = Attention(dim, heads)
        self.ffn1 = nn.Linear(dim, 4 * dim)
        self.ffn2 = nn.Linear(4 * dim, dim)

    def __call__(self, x, cond, valid, prec):
        mod = R.linear(cond, self.mod.weight, self.mod.bias, prec)[:, None, :]
        sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
        h = R.rope(R.layer_norm(x, None, None, prec) * (1 + sc1) + sh1)
        x = x + g1 * self.attn(h, valid, prec)
        h = R.layer_norm(x, None, None, prec) * (1 + sc2) + sh2
        h = R.linear(R.gelu(R.linear(h, self.ffn1.weight, self.ffn1.bias, prec)),
                     self.ffn2.weight, self.ffn2.bias, prec)
        return x + g2 * h


class Encoder(nn.Module):
    """``pre`` (when the widths differ), blocks, ``post`` (likewise), masked."""

    def __init__(self, dim_in: int, dim: int, dim_out: int, n_layers: int, heads: int,
                 cond_dim: tp.Optional[int] = None):
        super().__init__()
        self.pre = nn.Linear(dim_in, dim) if dim_in != dim else None
        self.blocks = nn.ModuleList(
            (DiTBlock(dim, cond_dim, heads) if cond_dim else TransformerBlock(dim, heads))
            for _ in range(n_layers))
        self.post = nn.Linear(dim, dim_out) if dim != dim_out else None

    def __call__(self, x, lengths, prec, cond=None):
        if self.pre is not None:
            x = R.linear(x, self.pre.weight, self.pre.bias, prec)
        valid = R.seq_mask(lengths, x.shape[1])
        for blk in self.blocks:
            x = blk(x, cond, valid, prec) if cond is not None else blk(x, valid, prec)
        if self.post is not None:
            x = R.linear(x, self.post.weight, self.post.bias, prec)
        return x * valid[..., None].to(x.dtype)


class CatCondition(nn.Module):
    def __init__(self, dim: int, cond_dim: int):
        super().__init__()
        self.proj = nn.Linear(dim + cond_dim, dim)

    def __call__(self, x, cond, prec):
        c = cond[:, None, :].expand(x.shape[0], x.shape[1], cond.shape[-1]).to(x.dtype)
        return R.linear(torch.cat([x, c], dim=-1), self.proj.weight, self.proj.bias, prec)


class VarianceAdaptor(nn.Module):
    def __init__(self, dim: int, variances: tp.Sequence[dict]):
        super().__init__()
        self.predictors = nn.ModuleDict()
        cur = dim
        for v in variances:
            if v["name"] == "durations":
                self.predictors["durations"] = Predictor(cur, v.get("dim", 256), 2, 3)
            else:
                self.predictors[v["name"]] = Predictor(cur, v.get("dim", 256),
                                                       v.get("n_layers", 3),
                                                       v.get("kernel_size", 5))
                cur += 1
        self.dim_out = cur


class CFMDecoder(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dim: int, n_layers: int, heads: int,
                 cond_dim: int):
        super().__init__()
        self.prior = nn.Linear(dim_in, dim_out)
        self.estimator = Encoder(2 * dim_out + dim_in, dim, dim_out, n_layers, heads,
                                 cond_dim=cond_dim + dim)
        self.time_mlp1 = nn.Linear(dim, dim)
        self.time_mlp2 = nn.Linear(dim, dim)
        self.fake_content = nn.Parameter(torch.zeros(dim_in))
        self.fake_condition = nn.Parameter(torch.zeros(cond_dim))
        self.dim = dim


class AcousticModel(nn.Module):
    """The inference call: ``infer`` (encoder to log-durations), ``regulate``
    (rounded durations, the alignment, the output lengths) and ``decode``
    (from an alignment to the postnet mel), so that a check can run the decode
    on the program's own alignment."""

    def __init__(self, cfg: dict):
        super().__init__()
        _cfg_check(cfg)
        self.cfg = cfg
        emb = cfg["token_emb_dim"]
        self.token_emb = nn.Embedding(cfg["n_symbols"], emb)
        self.ling_proj = nn.Linear(cfg["ling_feat_dim"], emb)
        self.lm_proj = nn.Linear(cfg["lm_feat_dim"], emb)
        self.xpbert_proj = nn.Linear(cfg["xpbert_feat_dim"], emb)
        self.speaker_emb = nn.Embedding(cfg["n_speakers"], cfg["speaker_emb_dim"])
        cond_dim = cfg["speaker_emb_dim"]
        if cfg["n_langs"] > 1:
            self.lang_emb = nn.Embedding(cfg["n_langs"], cfg.get("lang_emb_dim", 32))
            cond_dim += cfg.get("lang_emb_dim", 32)
        self.conds = nn.ModuleDict({"level0": CatCondition(emb, cond_dim)})
        self.encoder = Encoder(emb, cfg["encoder_dim"], cfg["encoder_dim"],
                               cfg["encoder_layers"], cfg["encoder_heads"])
        self.variance_adaptor = VarianceAdaptor(cfg["encoder_dim"], cfg["variances"])
        va = self.variance_adaptor.dim_out
        self.conds["level2"] = CatCondition(va, cond_dim)
        self.decoder = CFMDecoder(va, cfg["n_mels"], cfg["decoder_dim"], cfg["decoder_layers"],
                                  cfg["decoder_heads"], cond_dim)
        self.postnet = ConvStack(cfg["n_mels"], cfg["postnet_dim"], cfg["n_mels"],
                                 cfg["postnet_layers"], 5)
        self.gate_head = nn.Linear(cfg["n_mels"], 1)

    def condition(self, speaker_id, lang_id, prec):
        parts = [self.speaker_emb.weight[speaker_id.clamp(min=0)]]
        if hasattr(self, "lang_emb"):
            parts.append(self.lang_emb.weight[lang_id.clamp(min=0)])
        return torch.cat(parts, dim=-1).to(prec.dtype)

    def infer(self, inputs: dict, prec: R.Precision):
        """-> (content after the variances (B, N, D), the condition, log-durations (B, N))."""
        lens = inputs["transcription_lengths"]
        x = self.token_emb.weight[inputs["transcription"]].to(prec.dtype)
        for name, proj in (("ling_feat", self.ling_proj), ("lm_feat", self.lm_proj),
                           ("xpbert_feat", self.xpbert_proj)):
            x = x + R.linear(inputs[name], proj.weight, proj.bias, prec)
        cond = self.condition(inputs["speaker_id"], inputs["lang_id"], prec)
        x = self.conds["level0"](x, cond, prec)
        x = self.encoder(x, lens, prec)
        preds = self.variance_adaptor.predictors
        for name in ("aggregate_pitch", "aggregate_energy"):
            x = torch.cat([x, preds[name](x, lens, prec)[..., None].to(x.dtype)], dim=-1)
        log_d = preds["durations"](x, lens, prec)
        return x, cond, log_d

    @staticmethod
    def regulate(log_d: torch.Tensor, lens: torch.Tensor, t_out: int):
        """Rounded durations -> (alignment (B, t_out, N), output lengths (B,))."""
        d = torch.clamp(torch.expm1(log_d.float()), min=0.0)
        d = torch.round(d * R.seq_mask(lens, d.shape[1]).float())
        cum = torch.cumsum(d, dim=-1)
        t = torch.arange(t_out, dtype=torch.float32, device=d.device)[None, :, None]
        align = ((t >= (cum - d)[:, None, :]) & (t < cum[:, None, :])).float()
        return align, torch.clamp(d.sum(-1), 1, t_out).to(torch.int32)

    def decode(self, content, cond, align, out_lens, noise, prec, n_steps=None,
               cfg_scale=None):
        """The regulated content through the CFM solve and the postnet -> mel (B, T, n_mels)."""
        dec = self.decoder
        x = torch.matmul(align.to(prec.dtype), content.to(prec.dtype))
        x = self.conds["level2"](x, cond, prec)
        mu = R.linear(x, dec.prior.weight, dec.prior.bias, prec)
        n_steps = n_steps or self.cfg["cfm_n_timesteps"]
        cfg_scale = self.cfg.get("cfm_cfg_scale", 0.0) if cfg_scale is None else cfg_scale
        s = torch.linspace(0.0, 1.0, n_steps + 1, dtype=torch.float32)
        ts = 1.0 - torch.cos(0.5 * math.pi * s)
        dts = ts[1:] - ts[:-1]
        b = mu.shape[0]
        if cfg_scale > 0:
            content_in = torch.cat([x, dec.fake_content.to(x.dtype).expand_as(x)], dim=0)
            mu_in = torch.cat([mu, mu], dim=0)
            cond_in = torch.cat([cond, dec.fake_condition.to(cond.dtype).expand_as(cond)], 0)
            lens_in = torch.cat([out_lens, out_lens], dim=0)
        else:
            content_in, mu_in, cond_in, lens_in = x, mu, cond, out_lens
        y = noise.to(prec.dtype)
        for t, dt in zip(ts[:-1].tolist(), dts.tolist()):
            y_in = torch.cat([y, y], dim=0) if cfg_scale > 0 else y
            tb = torch.full((y_in.shape[0],), t, dtype=torch.float32, device=y.device)
            temb = R.sinusoidal(tb * 1000.0, dec.dim).to(prec.dtype)
            temb = R.linear(F.silu(R.linear(temb, dec.time_mlp1.weight, dec.time_mlp1.bias,
                                            prec)), dec.time_mlp2.weight, dec.time_mlp2.bias,
                            prec)
            c_full = torch.cat([cond_in, temb], dim=-1)
            v = dec.estimator(torch.cat([y_in, mu_in, content_in], dim=-1), lens_in, prec,
                              cond=c_full)
            if cfg_scale > 0:
                v = v[:b] + cfg_scale * (v[:b] - v[b:])
            y = y + dt * v
        valid = R.seq_mask(out_lens, y.shape[1])[..., None].to(prec.dtype)
        y = y * valid
        post = y + self.postnet(y, prec)
        return post * valid

    def forward(self, inputs: dict, t_out: int, noise: torch.Tensor, prec: R.Precision):
        """The whole inference call -> dict(log_d, align, lengths, mel)."""
        content, cond, log_d = self.infer(inputs, prec)
        align, out_lens = self.regulate(log_d, inputs["transcription_lengths"], t_out)
        mel = self.decode(content, cond, align, out_lens, noise, prec)
        return {"log_d": log_d, "align": align, "lengths": out_lens, "mel": mel}
