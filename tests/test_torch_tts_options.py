"""Every option of the acoustic-model kit the JAX package builds, held against it
on the CPU (f32): the variance options (``as_embedding``, multi-stream routing,
``use_discriminator``, ``use_gradtts_fa``, the soft length regulator), the model
switches (per-utterance averages, named condition sources, the inverse-speaker
classifier, the VQ / source-filter / linguistic-condition / conformer encoders,
the Tacotron decoder), each in a teacher-forced training call with every loss of
the criterion (and, where the option routes gradients, the gradients of their
sum), and in the inference call where it has one; ``maximum_path`` with ties;
the soft regulator; ``VarianceEmbedding``'s bins; the fresh weights of every new
module against flax's initialisers. Durations are given (the training call) or
the duration predictor's bias makes tokens 3 frames long (inference); the
Tacotron prenet's dropout masks are the JAX decoder's own next draws.

Tolerances: ``TOL`` (2e-4 of scale, as ``test_torch_tts_train``'s whole-model
tolerance) for outputs and losses, ``GRAD_TOL`` for gradients."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.convert import flatten_nnx, nnx_from_module
from speechflow_torch.models.tts import TTSCriterion, TTSTarget
from speechflow_torch.models.tts.common import VarianceEmbedding
from speechflow_torch.models.tts.model import ParallelTTSModel, ParallelTTSParams
from speechflow_torch.ops.length_regulator import length_regulate_soft
from speechflow_torch.ops.mas import maximum_path
from tests.torch_parity import n, no_dropout, port, randomize, t, tts_arrays, tts_params

torch.set_num_threads(1)
TOL = 2e-4
GRAD_TOL = 2e-4
B, N, N_MELS, T_MEL = 2, 13, 12, 72
LENS = np.array([N, 9])

_P, _E, _D = ({"name": "aggregate_pitch", "dim": 16}, {"name": "aggregate_energy", "dim": 16},
              {"name": "durations", "dim": 16})
AVERAGES = {"rate": {"interval": [0.0, 10.0], "n_bins": 8, "emb_dim": 4},
            "loud": {"interval": [1.0, 100.0], "n_bins": 16, "emb_dim": 3, "log_scale": True}}
CASES = {
    "as_embedding": dict(variances=[
        dict(_P, as_embedding=True, log_scale_embedding=True, interval=[50.0, 400.0],
             n_bins=32, emb_dim=6),
        dict(_E, as_embedding=True, interval=[0.0, 20.0], n_bins=16, emb_dim=5), _D]),
    "multi_stream": dict(encoder_type="context", encoder_concat_streams=False,
                         encoder_sub_types=("cnn", "rnn"), condition_levels=(0, 1, 2),
                         variances=[dict(_P, cat_to_streams=(0, 1)),
                                    dict(_E, input_stream=1, as_embedding=True,
                                         interval=[0.0, 20.0], emb_dim=3),
                                    dict(_D, input_stream=1)]),
    "discriminator": dict(variances=[dict(_P, use_discriminator=True, disc_dim=8),
                                     dict(_E, use_discriminator=True, disc_dim=8), _D]),
    "gradtts_fa": dict(variances=[_P, _E, dict(_D, use_gradtts_fa=True, fa_feat_dim=N_MELS,
                                               fa_dim=16)]),
    "soft_regulator": dict(soft_length_regulator=True),
    "average_emb": dict(use_average_emb=True, averages=AVERAGES),
    "condition_sources": dict(
        use_average_emb=True, averages=AVERAGES, condition_source_dims={"ssl_feat": 7},
        condition_sources=("speaker", "lang<detach", "average_rate", "speech_quality_emb",
                           "ssl_feat<detach")),
    "inverse_speaker": dict(use_inverse_speaker_classifier=True),
    "vq_encoder": dict(encoder_type="vq"),
    "sf_encoder": dict(encoder_type="sf"),
    "ling_condition": dict(encoder_type="ling_condition"),
    "conformer_remat": dict(encoder_type="conformer", use_remat=True),
    "taco": dict(decoder_type="taco"),
}
# the options whose point is where gradients go (reversal, detach, LSGAN sides, VQ)
GRAD_CASES = ["discriminator", "condition_sources", "inverse_speaker", "vq_encoder"]
INFER_CASES = ["gradtts_fa", "soft_regulator", "average_emb", "condition_sources", "taco",
               "multi_stream"]


def _params(case: str) -> dict:
    base = dict(decoder_type="wrapper", decoder_inner="transformer", decoder_layers=1,
                encoder_layers=1, n_mels=N_MELS)
    return tts_params(**dict(base, **CASES[case]))


def _arrays(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    a = tts_arrays(rng, B, N, LENS)
    mel_lens = a["durations"].sum(1).astype(np.int32)
    frames = np.arange(T_MEL)[None] < mel_lens[:, None]
    valid = np.arange(N)[None] < LENS[:, None]
    a.update(mel=(rng.normal(size=(B, T_MEL, N_MELS)) * frames[..., None]).astype(np.float32),
             mel_lengths=mel_lens,
             aggregate_pitch=(rng.uniform(80, 300, (B, N)) * valid).astype(np.float32),
             aggregate_energy=(rng.uniform(0, 20, (B, N)) * valid).astype(np.float32),
             gate=(np.arange(T_MEL)[None] >= mel_lens[:, None] - 1).astype(np.float32),
             speech_quality_emb=rng.normal(size=(B, 5)).astype(np.float32),
             ssl_feat=rng.normal(size=(B, T_MEL, 7)).astype(np.float32),
             averages={"rate": rng.uniform(0, 10, B).astype(np.float32),
                       "loud": rng.uniform(1, 100, B).astype(np.float32)})
    return a


def _jin(a: dict, raw_text: bool = False):
    from speechflow_tpu.models.tts.data_types import TTSForwardInput as JIn

    names = {f.name for f in dataclasses.fields(JIn)}
    skip = {"mel", "mel_lengths", "durations", "averages", "ssl_feat", "aggregate_pitch",
            "aggregate_energy"} if raw_text else set()
    out = {k: jnp.asarray(v) for k, v in a.items() if k in names and k != "averages"
           and k not in skip}
    if "averages" not in skip:
        out["averages"] = {k: jnp.asarray(v) for k, v in a["averages"].items()}
    return JIn(**out)


def _tin(a: dict, raw_text: bool = False):
    from speechflow_torch.models.tts import TTSForwardInput

    names = {f.name for f in dataclasses.fields(TTSForwardInput)}
    skip = {"mel", "mel_lengths", "durations", "averages", "ssl_feat", "aggregate_pitch",
            "aggregate_energy"} if raw_text else set()
    out = {k: t(v) for k, v in a.items() if k in names and k != "averages" and k not in skip}
    if "averages" not in skip:
        out["averages"] = {k: t(v) for k, v in a["averages"].items()}
    return TTSForwardInput(**out)


def _targets(a: dict, jax_side: bool):
    from speechflow_tpu.models.tts.data_types import TTSTarget as JTarget

    cls, conv = (JTarget, jnp.asarray) if jax_side else (TTSTarget, t)
    return cls(**{f.name: conv(a[f.name]) for f in dataclasses.fields(TTSTarget)
                  if a.get(f.name) is not None})


def _pair(case: str):
    from speechflow_tpu.models.tts import ParallelTTSModel as J
    from speechflow_tpu.models.tts import ParallelTTSParams as JP

    params = _params(case)
    jm = randomize(J(JP.create(params), rngs=nnx.Rngs(0)))
    va = jm.variance_adaptor.predictors["durations"]
    out = va.dp_out if hasattr(va, "dp_out") else va.out
    # inference: log(1 + 3) (exp(log 3) for the aligner) -> 3 frames a token
    out.bias[...] = jnp.full((1,), math.log(3.0) if hasattr(va, "dp_out") else math.log(4.0))
    tm = port(ParallelTTSModel(ParallelTTSParams.create(params)), jm)
    no_dropout(jm, tm)
    return jm, tm


def _criteria():
    from speechflow_tpu.models.tts import TTSCriterion as JCrit

    kw = dict(inverse_speaker_scale=0.5)
    return JCrit(**kw), TTSCriterion(**kw)


def _taco_masks(jm, t_frames: int):
    """The prenet masks the JAX Tacotron decoder draws in its next training call."""
    dec = nnx.clone(jm).decoder
    keep = 1.0 - dec.prenet_dropout
    k1, k2 = jax.random.split(dec.rngs.params())
    return tuple(t(np.asarray(jax.random.bernoulli(k, keep, (t_frames, B, dec.prenet_dim))
                              / keep).astype(np.float32)) for k in (k1, k2))


def _close(ours, ref, what: str, tol: float = TOL, rows=None):
    ref = np.asarray(ref, np.float32)
    ours = n(ours)
    assert ours.shape == ref.shape, what
    if rows is not None:
        ours, ref = ours[rows], ref[rows]
    np.testing.assert_allclose(ours, ref, atol=tol * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_call_matches_jax(case):
    """The teacher-forced call: the mel stages and gate on valid frames, every
    variance prediction and extra output, every loss of the criterion."""
    jm, tm = _pair(case)
    a = _arrays()
    jc, tc = _criteria()
    masks = _taco_masks(jm, T_MEL) if case == "taco" else None
    ref = jm(_jin(a), training=True, deterministic=True)
    out = tm.train()(_tin(a), training=True, deterministic=True, prenet_masks=masks)
    frames = np.arange(T_MEL)[None] < a["mel_lengths"][:, None]
    _close(out.spectrogram.permute(1, 2, 0, 3)[t(frames)],
           np.asarray(ref.spectrogram).transpose(1, 2, 0, 3)[frames], "spectrogram")
    _close(out.gate[t(frames)], np.asarray(ref.gate)[frames], "gate")
    assert set(out.variance_predictions) == set(ref.variance_predictions)
    for k, v in ref.variance_predictions.items():
        _close(out.variance_predictions[k], v, k)
    assert set(out.additional_content) == set(ref.additional_content)
    for k, v in ref.additional_content.items():
        _close(out.additional_content[k], v, k)
    ref_l = jc(ref, _targets(a, True), jnp.asarray(0))
    ours_l = tc(out, _targets(a, False), 0)
    assert set(ours_l) == set(ref_l)
    for k in ref_l:
        _close(ours_l[k], ref_l[k], k)


@pytest.mark.parametrize("case", GRAD_CASES)
def test_training_gradients_match_jax(case):
    """The gradients of the summed losses, parameter by parameter (in flax's
    layout): the reversal before the speaker classifiers, the detached
    sources, the discriminators' two sides."""
    jm, tm = _pair(case)
    a = _arrays(1)
    jc, tc = _criteria()
    tgt = _targets(a, True)

    def loss_fn(m):
        out = m(_jin(a), training=True, deterministic=True)
        return sum(jc(out, tgt, jnp.asarray(0)).values())

    ref = flatten_nnx(nnx.to_pure_dict(nnx.grad(loss_fn)(jm)))
    sum(tc(tm.train()(_tin(a), training=True, deterministic=True), _targets(a, False),
           0).values()).backward()
    grads = {k: p.grad for k, p in tm.named_parameters()}
    flat = flatten_nnx(nnx_from_module(_grad_view(tm, grads)))
    scale = max(np.abs(v).max() for v in ref.values())
    for k, r in ref.items():
        np.testing.assert_allclose(flat[k], r, atol=GRAD_TOL * max(np.abs(r).max(),
                                                                    1e-3 * scale), err_msg=k)


def _grad_view(module, grads):
    """A copy of ``module`` with each parameter replaced by its gradient (zeros
    where it has none), so ``nnx_from_module`` lays the gradients out as flax's tree."""
    import copy

    view = copy.deepcopy(module)
    with torch.no_grad():
        for name, p in view.named_parameters():
            g = grads[name]
            p.copy_(torch.zeros_like(p) if g is None else g)
    return view


@pytest.mark.parametrize("case", INFER_CASES)
def test_inference_call_matches_jax(case):
    """Raw text: no mel, targets or averages (the averages' interval midpoints,
    the aligner's and the duration predictor's durations, the Tacotron decoder's
    feedback decoding over a frame budget)."""
    jm, tm = _pair(case)
    a = _arrays(2)
    if case == "condition_sources":  # its sources are inputs a request carries
        jin, tin = _jin(a), _tin(a)
        jin = dataclasses.replace(jin, mel=None, mel_lengths=None, durations=None)
        tin = dataclasses.replace(tin, mel=None, mel_lengths=None, durations=None)
    else:
        jin, tin = _jin(a, raw_text=True), _tin(a, raw_text=True)
    t_out = 48
    ref = jm(jin, training=False, t_out=t_out)
    with torch.no_grad():
        out = tm.eval()(tin, t_out=t_out)
    np.testing.assert_array_equal(n(out.spectrogram_lengths), np.asarray(ref.spectrogram_lengths))
    frames = np.arange(t_out)[None] < np.asarray(ref.spectrogram_lengths)[:, None]
    _close(out.spectrogram.permute(1, 2, 0, 3)[t(frames)],
           np.asarray(ref.spectrogram).transpose(1, 2, 0, 3)[frames], "spectrogram")
    _close(out.gate[t(frames)], np.asarray(ref.gate)[frames], "gate")


def test_signal_discriminator_matches_jax():
    """The LSGAN losses and the gradients of their sum, the discriminator alone
    (one live channel of six after the first ReLU: in a whole model its LayerNorm
    amplifies the context's rounding, so the model-level case is 8 wide)."""
    from speechflow_tpu.models.tts.predictors import SignalDiscriminator as JD

    from speechflow_torch.models.tts.predictors import SignalDiscriminator as TD

    rng = np.random.default_rng(5)
    jd = randomize(JD(10, 6, rngs=nnx.Rngs(0)), seed=1)
    td = port(TD(10, 6), jd)
    ctx, real, fake = (rng.normal(size=s).astype(np.float32)
                       for s in ((B, N, 10), (B, N), (B, N)))

    def f(m):
        lo = m.lsgan_losses(jnp.asarray(ctx), jnp.asarray(real), jnp.asarray(fake),
                            jnp.asarray(LENS))
        return lo["disc_loss"] + lo["gen_loss"], lo

    (_, ref), grads = nnx.value_and_grad(f, has_aux=True)(jd)
    ours = td.lsgan_losses(t(ctx), t(real), t(fake), t(LENS))
    (ours["disc_loss"] + ours["gen_loss"]).backward()
    for k in ref:
        _close(ours[k], ref[k], k, tol=1e-6)
    ref_g = flatten_nnx(nnx.to_pure_dict(grads))
    got_g = flatten_nnx(nnx_from_module(_grad_view(td, {k: p.grad for k, p in
                                                       td.named_parameters()})))
    for k, r in ref_g.items():
        _close(got_g[k], r, k, tol=1e-5)


def test_maximum_path_matches_jax_with_ties():
    """Random grids at ragged lengths, and grids of integers where many paths
    tie: the same one-hot path, bit for bit (a tie stays on the token)."""
    from speechflow_tpu.ops.mas import maximum_path as jmp

    rng = np.random.default_rng(3)
    tl, ml = np.array([7, 4, 1, 5]), np.array([20, 9, 3, 5])
    for value in (rng.normal(size=(4, 7, 20)).astype(np.float32),
                  rng.integers(0, 2, (4, 7, 20)).astype(np.float32),
                  np.zeros((4, 7, 20), np.float32)):
        ref = np.asarray(jmp(jnp.asarray(value), jnp.asarray(tl), jnp.asarray(ml)))
        ours = n(maximum_path(t(value), t(tl), t(ml)))
        np.testing.assert_array_equal(ours, ref)
        assert (ours.sum(1)[np.arange(20)[None] < ml[:, None]] == 1).all()


def test_soft_regulator_matches_jax():
    from speechflow_tpu.ops.length_regulator import length_regulate_soft as jls

    rng = np.random.default_rng(4)
    content = rng.normal(size=(B, N, 6)).astype(np.float32)
    dur = (rng.uniform(0.5, 4.0, (B, N)) * (np.arange(N)[None] < LENS[:, None])).astype(
        np.float32)
    mask = np.arange(N)[None] < LENS[:, None]
    for tm in (None, mask):
        ref = jls(jnp.asarray(content), jnp.asarray(dur), 40, token_mask=None if tm is None
                  else jnp.asarray(tm))
        ours = length_regulate_soft(t(content), t(dur), 40,
                                    token_mask=None if tm is None else t(tm))
        for o, r in zip(ours, ref):
            _close(o, r, "soft", tol=1e-6)


def test_variance_embedding_bins_match_jax():
    """The bins JAX's float32 arithmetic and truncating cast give, on values
    around the interval, its edges and below it (log scale too)."""
    from speechflow_tpu.models.tts.common import VarianceEmbedding as JV

    x = np.concatenate([np.linspace(-30, 920, 4001), [0.0, 880.0, 50.0, 1e-7, -1e-7]]
                       ).astype(np.float32)
    for log in (False, True):
        jv = JV((50.0, 880.0), 37, 3, log_scale=log, rngs=nnx.Rngs(0))
        tv = port(VarianceEmbedding((50.0, 880.0), 37, 3, log_scale=log), jv)
        np.testing.assert_array_equal(n(tv(t(x))), np.asarray(jv(jnp.asarray(x))))


# encoders that no case above builds in a model
FRESH_ONLY = {"cbhg_encoder": dict(encoder_type="cbhg"),
              "variance_encoder": dict(encoder_type="variance_encoder"),
              "vq_codebook": dict(encoder_type="vq"),
              "dummy_encoder": dict(encoder_type="dummy", token_emb_dim=32)}


@pytest.mark.parametrize("case", ["multi_stream", "gradtts_fa", "condition_sources",
                                  "discriminator", "taco", "conformer_remat", "sf_encoder",
                                  "ling_condition", "inverse_speaker", "as_embedding",
                                  *FRESH_ONLY])
def test_fresh_weights_follow_flax_initialisers(case):
    """A model built from its params starts from the JAX model's distribution
    (the test of ``test_torch_tts_train``, over the new modules): every tensor
    all zero or all one in JAX's is so in the port's, every other one's standard
    deviation within 6/sqrt(size) of JAX's and its mean within six standard
    errors of 0 (recurrent kernels orthogonal, as flax's)."""
    from speechflow_tpu.models.tts import ParallelTTSModel as J
    from speechflow_tpu.models.tts import ParallelTTSParams as JP

    params = tts_params(**FRESH_ONLY[case]) if case in FRESH_ONLY else _params(case)
    ref = flatten_nnx(nnx.to_pure_dict(nnx.state(J(JP.create(params), rngs=nnx.Rngs(0)),
                                                 nnx.Param)))
    torch.manual_seed(0)
    got = flatten_nnx(nnx_from_module(ParallelTTSModel(ParallelTTSParams.create(params))))
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if not r.any() or (r == 1).all():
            np.testing.assert_array_equal(g, r, err_msg=k)
            continue
        if r.size < 16:  # a handful of draws says nothing of a distribution
            continue
        assert abs(g.std() / r.std() - 1) <= 6 / np.sqrt(r.size), k
        assert abs(g.mean()) <= 6 * g.std() / np.sqrt(r.size) + 1e-7, k


def test_train_tts_forward_recipe_and_serve_it(tmp_path):
    """``train_tts -c configs/tts_forward.yml -vs debug --device cpu`` for 2 steps
    (bi-GRU encoder and wrapper decoder, bucketed pitch and energy): finite
    losses, a checkpoint whose model tree fills the JAX model of the same params
    (shapes strict), served as text -> mel by the TTS interface."""
    from speechflow_tpu.models.tts import ParallelTTSModel as J
    from speechflow_tpu.models.tts import ParallelTTSParams as JP

    from speechflow_torch.interface.tts_interface import TTSEvaluationInterface
    from speechflow_torch.scripts import train_tts
    from speechflow_torch.training.saver import ExperimentSaver

    expr = train_tts.main(["-c", "configs/tts_forward.yml", "-vs", "debug", "--device", "cpu",
                           "--max_steps", "2", "--experiment_dir", str(tmp_path)])
    ckpt = ExperimentSaver.get_last_checkpoint(expr)
    tree, payload = ExperimentSaver.load_checkpoint(ckpt)
    assert int(tree["step"]) == 2 and tree["opt"]["count"] == 2
    params = payload["model_params"]
    assert params["encoder_type"] == "rnn" and params["decoder_inner"] == "rnn"
    jm = J(JP.create(params), rngs=nnx.Rngs(0))
    state = nnx.state(jm, nnx.Param)
    nnx.replace_by_pure_dict(state, tree["model"])
    ref = flatten_nnx(nnx.to_pure_dict(state))
    assert set(ref) == set(flatten_nnx(tree["model"]))
    ti = TTSEvaluationInterface.from_checkpoint(tree, payload, ckpt_path=ckpt, device="cpu")
    out = ti.synthesize("Printing, in the only sense.", speaker=ti.get_speakers()[0])
    mel = out.after_postnet_spectrogram
    assert mel.shape[-1] == params["n_mels"] and torch.isfinite(mel).all()
    assert int(out.spectrogram_lengths.min()) > 0
