"""The benchmark's yardstick of work: the card's peaks, the least time a kernel's
work could take, and a model's operations, all from shapes and valid lengths.

Nothing here reads what the program executes: a later change that replaces a
kernel or a convolution is divided into the same work. Peaks are NVIDIA's
data sheet for one H100 SXM (dense, at its 700 W limit).
"""

from __future__ import annotations

import math
import typing as tp

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12,
            "fp8": 1979e12}
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    """The larger of the bytes over the memory bandwidth and the operations
    over the dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype])


# -- attention ---------------------------------------------------------------------


def attention_ops(heads: int, dh: int, lengths: tp.Sequence[int]) -> float:
    """q·kᵀ and w·v over valid rows × valid keys."""
    return 4.0 * heads * dh * sum(n * n for n in lengths)


def attention_bound_s(heads: int, dh: int, lengths: tp.Sequence[int], dtype: str) -> float:
    """One attention call over rows of the given valid lengths: q, k and v read
    and the output written once at valid positions only."""
    es = BYTES[dtype]
    nbytes = 4.0 * heads * dh * es * sum(lengths)
    return bound_s(nbytes, attention_ops(heads, dh, lengths), dtype)


# -- BigVGAN's anti-aliased snake ----------------------------------------------------


def activation_bound_s(samples: float, channels: int, dtype: str) -> float:
    """One anti-aliased snake over ``samples`` valid time steps (summed over
    rows) of ``channels``: its input read once and its output written once."""
    return 2.0 * BYTES[dtype] * samples * channels / HBM_BYTES_PER_S


def head_stages(rates: tp.Sequence[int], channels: int) -> tp.List[tp.Tuple[int, int]]:
    """(cumulative upsampling, channels) after each transposed convolution."""
    out, up, ch = [], 1, channels
    for r in rates:
        up *= r
        ch //= 2
        out.append((up, ch))
    return out


def head_activation_bound_s(frames: float, rates: tp.Sequence[int], channels: int,
                            n_branches: int, acts_per_branch: int, dtype: str) -> float:
    """Every anti-aliased snake of a BigVGAN head over ``frames`` valid mel frames
    (summed over rows). Within a stage the first activation of every branch reads
    the same input: it is counted once, with each branch's output."""
    es = BYTES[dtype]
    total = 0.0
    for up, ch in head_stages(rates, channels):
        n = frames * up * ch
        first = es * n * (1 + n_branches)
        rest = 2 * es * n * n_branches * (acts_per_branch - 1)
        total += first + rest
    up, ch = head_stages(rates, channels)[-1]
    total += 2 * es * frames * up * ch  # the activation before the output conv
    return total / HBM_BYTES_PER_S


# -- model operations (2 per multiply-add) ---------------------------------------------


def _lin(n: float, d_in: int, d_out: int) -> float:
    return 2.0 * n * d_in * d_out


def _conv(n: float, c_in: int, c_out: int, k: int, groups: int = 1) -> float:
    return 2.0 * n * c_in * c_out * k / groups


def transformer_ops(tokens: float, sq_lengths: float, dim: int, layers: int) -> float:
    """A stack of attention + 4x MLP blocks over ``tokens`` valid positions, the
    attention over Σ n² valid pairs (``sq_lengths``)."""
    per = _lin(tokens, dim, 4 * dim) + _lin(tokens, dim, 8 * dim)  # q,k,v,o and the MLP
    return layers * (per + 4.0 * dim * sq_lengths)


def acoustic_ops(cfg: dict, token_lengths: tp.Sequence[int],
                 frame_lengths: tp.Sequence[int]) -> float:
    """The flagship acoustic model's inference over valid tokens and frames: the
    encoder, the variance predictors, the condition projections, and the CFM
    decoder's estimator at every Euler step, doubled by batched CFG, then the
    postnet."""
    ntok = float(sum(token_lengths))
    nfr = float(sum(frame_lengths))
    emb, d_enc, d_dec = cfg["token_emb_dim"], cfg["encoder_dim"], cfg["decoder_dim"]
    n_mels = cfg["n_mels"]
    cond = cfg["speaker_emb_dim"] + (cfg.get("lang_emb_dim", 32) if cfg["n_langs"] > 1 else 0)
    feats = cfg["ling_feat_dim"] + cfg["lm_feat_dim"] + cfg["xpbert_feat_dim"]
    ops = _lin(ntok, feats, emb) + _lin(ntok, emb + cond, emb) + _lin(ntok, emb, d_enc)
    ops += transformer_ops(ntok, float(sum(n * n for n in token_lengths)), d_enc,
                           cfg["encoder_layers"])
    va = d_enc
    for v in cfg["variances"]:
        dim = v.get("dim", 256)
        if v["name"] == "durations":
            ops += _conv(ntok, va, dim, 3) + _conv(ntok, dim, dim, 3) + _lin(ntok, dim, 1)
        else:
            k, n = v.get("kernel_size", 5), v.get("n_layers", 3)
            ops += _conv(ntok, va, dim, k) + (n - 1) * _conv(ntok, dim, dim, k)
            ops += _lin(ntok, dim, 1)
            va += 1
    ops += _lin(nfr, va + cond, va) + _lin(nfr, va, n_mels)  # the condition, the prior
    passes = cfg["cfm_n_timesteps"] * (2 if cfg.get("cfm_cfg_scale", 0.0) > 0 else 1)
    est = _lin(nfr, 2 * n_mels + va, d_dec) + _lin(nfr, d_dec, n_mels)
    est += transformer_ops(nfr, float(sum(n * n for n in frame_lengths)), d_dec,
                           cfg["decoder_layers"])
    ops += passes * est
    pd = cfg["postnet_dim"]
    ops += _conv(nfr, n_mels, pd, 5) + (cfg["postnet_layers"] - 2) * _conv(nfr, pd, pd, 5)
    ops += _conv(nfr, pd, n_mels, 5)
    return ops


def vocoder_ops(cfg: dict, frames: float) -> float:
    """The Vocos backbone and the BigVGAN head over ``frames`` valid mel frames:
    the embedding conv, the ConvNeXt blocks, the head's input conv, each
    transposed convolution (kernel 2r at stride r: 2 taps an output), the
    multi-receptive-field convolutions (three dilations a branch) and the output
    conv."""
    d, n_mels = cfg["dim"], cfg["n_mels"]
    ratio = cfg.get("mlp_ratio", 3)
    ops = _conv(frames, n_mels, d, 7)
    ops += cfg["n_layers"] * (_conv(frames, d, d, 7, groups=d) + 2 * _lin(frames, d, ratio * d))
    ch = cfg["upsample_channels"]
    ops += _conv(frames, d, ch, 7)
    kernels = cfg["resblock_kernel_sizes"]
    for up, c in head_stages(cfg["upsample_rates"], ch):
        n = frames * up
        ops += 2.0 * n * (2 * c) * c * 2  # transposed conv: 2 taps of C_in x C_out
        ops += sum(3 * _conv(n, c, c, k) for k in kernels)
    up, c = head_stages(cfg["upsample_rates"], ch)[-1]
    ops += _conv(frames * up, c, 1, 7)
    return ops


def _conv2d(h: int, w: int, c_in: int, c_out: int, k: tp.Sequence[int],
            s: tp.Sequence[int] = (1, 1)) -> tp.Tuple[float, int, int]:
    """(operations, H_out, W_out) of one SAME 2-D convolution over an H x W map."""
    ho, wo = -(-h // s[0]), -(-w // s[1])
    return 2.0 * ho * wo * c_in * c_out * k[0] * k[1], ho, wo


def mpd_ops(periods: tp.Sequence[int], c: int, samples: int) -> float:
    """The multi-period discriminator over one waveform of ``samples``."""
    total = 0.0
    chs = [1, c, c * 4, c * 16, c * 32, c * 32]
    for p in periods:
        h = -(-samples // p)
        for i in range(5):
            ops, h, _ = _conv2d(h, p, chs[i], chs[i + 1], (5, 1), (3, 1) if i < 4 else (1, 1))
            total += ops
        total += _conv2d(h, p, chs[-1], 1, (3, 1))[0]
    return total


def cqt_disc_ops(sr: int, hop: int, n_octaves: int, bpo: int, c: int, samples: int) -> float:
    """One CQT scale over one waveform: the transform (frames x its kernels, each
    octave), the per-octave pre-convolutions and the convolution stack."""
    q = 1.0 / (2.0 ** (1.0 / bpo) - 1.0)
    f_low_top = 32.703195 * 2.0 ** (n_octaves - 1)
    length = 2 * math.ceil(math.ceil(q * 2 * sr / f_low_top) / 2)
    frames = 2 * samples // hop + 1
    total = n_octaves * 2.0 * frames * length * 2 * bpo
    total += n_octaves * _conv2d(frames, bpo, 2, 2, (3, 9))[0]
    w = n_octaves * bpo
    ops, _, w = _conv2d(frames, w, 2, c, (3, 9))
    total += ops
    ch = c
    for i in range(3):
        out = min(c * 2 ** (i + 1), 1024)
        ops, _, w = _conv2d(frames, w, ch, out, (3, 9), (1, 2))
        total += ops
        ch = out
    total += _conv2d(frames, w, ch, ch, (3, 3))[0] + _conv2d(frames, w, ch, 1, (3, 3))[0]
    return total


def disc_ops(cfg: dict, samples: int) -> float:
    """The recipe's discriminator (MPD + the sub-band CQT scales) over one waveform."""
    total = mpd_ops(cfg["periods"], cfg["channels"], samples)
    for hop, o, b in zip((512, 256, 256), cfg["cqt_n_octaves"], cfg["cqt_bins_per_octave"]):
        total += cqt_disc_ops(cfg["sample_rate"], hop, o, b, cfg["channels"], samples)
    return total


def gan_step_ops(gen: dict, disc: dict, rows: int, samples: int) -> float:
    """One GAN micro-batch of ``rows`` waveforms of ``samples``: the generator's
    forward and backward (3x its forward); in the generator's step the
    discriminator's forward on the fake and the real waveform and its backward to
    the fake one (3x a forward); in the discriminator's step its forward on both
    and its backward on both (6x)."""
    g = vocoder_ops(gen, float(rows * (samples // gen["hop_length"] + 1)))
    return 3.0 * g + 9.0 * rows * disc_ops(disc, samples)
