"""Shared helpers of the ``test_torch_*`` parity tests (not a test module).

Both packages get the same inputs (numpy, from a seed) and the same weights:
every float parameter of a JAX model is replaced by seeded random values
(flax's zero inits — DiT modulation, biases, snake parameters — would hide
layout faults), then ``speechflow_torch.convert`` copies them into the
port's module.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from speechflow_torch.convert import load_nnx_state


def randomize(model: nnx.Module, seed: int = 0) -> nnx.Module:
    """Matrices/kernels uniform in ±1/sqrt(fan_in) (fan_in = product of all
    but the last axis); vectors 0.1·N(0, 1), plus 1 for norm scales."""
    rng = np.random.default_rng(seed)
    state = nnx.state(model, nnx.Param)
    pure = nnx.to_pure_dict(state)

    def fill(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = fill(v)
                continue
            a = np.asarray(v)
            if a.ndim >= 2:
                b = 1.0 / np.sqrt(np.prod(a.shape[:-1]))
                new = rng.uniform(-b, b, a.shape)
            else:
                new = 0.1 * rng.normal(size=a.shape) + (1.0 if k == "scale" else 0.0)
            out[k] = new.astype(a.dtype)
        return out

    nnx.replace_by_pure_dict(state, fill(pure))
    nnx.update(model, state)
    return model


def port(module: torch.nn.Module, jax_model: nnx.Module) -> torch.nn.Module:
    """Copy ``jax_model``'s weights into ``module``; returns it in eval mode."""
    load_nnx_state(module, nnx.to_pure_dict(nnx.state(jax_model)))
    return module.eval()


def assert_grads_match(module: torch.nn.Module, jax_grads, tol: float) -> None:
    """Every parameter gradient of ``module`` (after a backward) within ``tol``
    of the largest magnitude of its JAX counterpart in ``jax_grads`` (an nnx
    state of gradients), in flax's layout."""
    from speechflow_torch.convert import _mappings, flatten_nnx

    flat = flatten_nnx(nnx.to_pure_dict(jax_grads))
    for name, param, src, _, to_flax in _mappings(module):
        if not param.requires_grad:
            continue
        ref = flat[src]
        got = to_flax(n(param.grad))
        err = float(np.abs(got - ref).max())
        assert err <= tol * max(float(np.abs(ref).max()), 1e-30), \
            (name, err / max(float(np.abs(ref).max()), 1e-30))


def t(x) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor (copy)."""
    return torch.from_numpy(np.array(x))


def n(x) -> np.ndarray:
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


D = 32  # model width of the narrow configurations
VARIANCES = [{"name": "aggregate_pitch", "dim": 16}, {"name": "aggregate_energy", "dim": 16},
             {"name": "durations", "dim": 16}]


def tts_params(**kw) -> dict:
    """The flagship's shape (transformer encoder, CFM-DiT decoder with CFG,
    all three token features, two languages, cat conditioning at levels 0
    and 2, gate) at narrow widths."""
    p = dict(n_symbols=20, n_speakers=3, n_langs=2, n_mels=12, token_emb_dim=16,
             encoder_type="transformer", encoder_dim=D, encoder_layers=2, encoder_heads=2,
             decoder_type="cfm", decoder_dim=D, decoder_layers=2, decoder_heads=2,
             cfm_n_timesteps=4, cfm_cfg_scale=1.0, speaker_emb_dim=8, lang_emb_dim=4,
             postnet_dim=16, postnet_layers=3, max_output_length=96, use_gate=True,
             use_ling_feat=True, use_lm_feat=True, use_xpbert_feat=True,
             ling_feat_dim=56, lm_feat_dim=32, xpbert_feat_dim=32, dropout=0.0,
             variances=VARIANCES)
    p.update(kw)
    return p


def jax_tts_model(params: dict, frames_per_token: float = 3.0):
    """The JAX acoustic model with random weights, its duration predictor's
    output bias set so that tokens last a few frames."""
    from speechflow_tpu.models.tts import ParallelTTSModel as J
    from speechflow_tpu.models.tts import ParallelTTSParams as JP

    jm = randomize(J(JP.create(params), rngs=nnx.Rngs(0)))
    jm.variance_adaptor.predictors["durations"].out.bias[...] = jnp.full(
        (1,), math.log1p(frames_per_token))
    return jm


def vocoder_params(**kw) -> dict:
    """The flagship vocoder's kind (audio features -> Vocos backbone ->
    snake_upsample head with a 3-branch MRF) at narrow widths."""
    p = dict(feature_extractor="audio", input_feature="mel", n_mels=10, backbone="vocos",
             head="snake_upsample", dim=16, n_layers=2, upsample_rates=[4, 2, 2],
             upsample_channels=32, resblock_kernel_sizes=[3, 7, 11], hop_length=16)
    p.update(kw)
    return p


def tts_arrays(rng, b: int, n: int, lengths, n_symbols: int = 20, n_speakers: int = 3,
               n_langs: int = 2, feat_dims=(56, 32, 32)) -> dict:
    """Numpy fields of one acoustic-model request batch: tokens, ragged
    lengths, speakers, languages, ling/LM/XPBERT features and teacher
    durations (2..5 frames a token, zero past each length)."""
    lengths = np.asarray(lengths, np.int32)
    valid = np.arange(n)[None] < lengths[:, None]
    ling, lm, xp = (rng.normal(size=(b, n, d)).astype(np.float32) for d in feat_dims)
    return dict(
        transcription=np.where(valid, rng.integers(1, n_symbols, (b, n)), 0).astype(np.int32),
        transcription_lengths=lengths,
        speaker_id=rng.integers(0, n_speakers, (b,)).astype(np.int32),
        lang_id=rng.integers(0, n_langs, (b,)).astype(np.int32),
        durations=np.where(valid, rng.integers(2, 6, (b, n)), 0).astype(np.float32),
        ling_feat=ling, lm_feat=lm, xpbert_feat=xp,
    )


def jax_tts_input(arrays: dict):
    from speechflow_tpu.models.tts.data_types import TTSForwardInput as JaxInput

    return JaxInput(**{k: jnp.asarray(v) for k, v in arrays.items()})


def torch_tts_input(arrays: dict):
    from speechflow_torch.models.tts import TTSForwardInput

    return TTSForwardInput(**{k: t(v) for k, v in arrays.items()})


def cfm_noise(jax_model, shape) -> np.ndarray:
    """The initial CFM state the JAX model's next ``generate`` draws: the key
    comes from a clone of its decoder's rng stream (the model is untouched)."""
    dec = nnx.clone(jax_model).decoder if hasattr(jax_model, "decoder") \
        else nnx.clone(jax_model)
    key = dec.rngs.params()
    return np.asarray(jax.random.normal(key, shape, jnp.float32) * dec.temperature)



def cfm_train_draws(jax_model, batch: int, target_shape, n: int = 1) -> list:
    """The u, z and CFG drop masks of the JAX model's next ``n`` training calls
    (``CFMDecoder.forward_train`` splits each key 4 ways: u, z, content mask,
    condition mask), from a clone of its decoder's rng stream, as CPU tensors
    for the port's ``CFMDraws`` (None for each call of a model without a CFM)."""
    from speechflow_torch.models.tts.decoders import CFMDraws

    dec = nnx.clone(jax_model).decoder
    if not hasattr(dec, "cfg_dropout"):
        return [None] * n
    out = []
    for _ in range(n):
        k1, k2, k3, k4 = jax.random.split(dec.rngs.params(), 4)
        out.append(CFMDraws(
            t(jax.random.uniform(k1, (batch,))), t(jax.random.normal(k2, tuple(target_shape))),
            t(jax.random.bernoulli(k3, dec.cfg_dropout, (batch, 1, 1))),
            t(jax.random.bernoulli(k4, dec.cfg_dropout, (batch, 1)))))
    return out


def no_dropout(jax_model: nnx.Module, module: torch.nn.Module) -> None:
    """Every dropout rate of both models to 0 (flax's ``Dropout.rate`` and
    ``MultiHeadAttention.dropout_rate``; the port's ``dropout`` attributes)."""
    for _, node in nnx.iter_graph(jax_model):
        if isinstance(node, nnx.Dropout):
            node.rate = 0.0
        elif isinstance(node, nnx.MultiHeadAttention):
            node.dropout_rate = 0.0
    for m in module.modules():
        if isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0
