"""The acoustic model's training half against the JAX package (f32, CPU).

``ParallelTTSModel``'s teacher-forced call at the ``debug`` config of
``configs/tts_model.yml`` (wrapper decoder) and at the same config with the
CFM decoder (2 layers, width 64): outputs on valid rows, every loss of the
criterion, the gradients of their sum (``nnx.value_and_grad``), and
``Trainer`` steps. Dropout is off (``deterministic=True``, or every rate 0
where the trainer runs the training call); the CFM's u, z and CFG masks are
the JAX decoder's own next draws (``cfm_train_draws``). Plus the fresh
weights' initialisers, the dropout rates the port builds, the attention
switch, and validation.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.convert import flatten_nnx, nnx_from_module, state_dict_from_nnx
from speechflow_torch.data.collate import CollatedTTS
from speechflow_torch.models.tts import TTSCriterion, TTSTarget
from speechflow_torch.models.tts.batch_processor import TTSBatchProcessor
from speechflow_torch.models.tts.model import ParallelTTSModel, ParallelTTSParams
from speechflow_torch.ops import attention as A
from speechflow_torch.scripts.train_tts import configs
from speechflow_torch.training.optimizer import OptimizerConfig
from speechflow_torch.training.trainer import Trainer, TrainerConfig
from tests.torch_parity import (
    cfm_train_draws,
    jax_tts_input,
    jax_tts_model,
    n,
    no_dropout,
    port,
    t,
    torch_tts_input,
    tts_arrays,
)

torch.set_num_threads(1)
MODEL_TOL = 2e-4  # outputs and losses of the whole acoustic model in f32
# each gradient, of its tensor's largest magnitude, or of 1e-3 of the model's largest
# gradient where that is more: the attention key biases' true gradient is 0 (softmax
# is shift-invariant), so both sides hold only rounding there (~1e-8)
GRAD_TOL = 2e-4
LR = 1e-3         # the debug recipe's AdamW
B, N, N_MELS = 2, 13, 16
T_MEL = 72  # frames: at least N tokens x 5
LENS = np.array([N, 9])


def _params(decoder: str) -> dict:
    model = dict(configs("debug")[0]["model"], n_symbols=20, n_speakers=3, n_langs=2,
                 n_mels=N_MELS, decoder_type=decoder)
    model["variances"] = [dict(v) for v in model["variances"]]
    return model


def _batch(seed: int = 0) -> dict:
    """Collated arrays of a training batch: tokens and features, 2..5 frames
    a token, a mel of ``T_MEL`` frames valid as far as the durations reach,
    the gate 1 from each row's last frame on."""
    rng = np.random.default_rng(seed)
    arrays = tts_arrays(rng, B, N, LENS)
    mel_lens = arrays["durations"].sum(1).astype(np.int32)
    t_mel = T_MEL
    frames = np.arange(t_mel)[None] < mel_lens[:, None]
    valid = np.arange(N)[None] < LENS[:, None]
    arrays.update(
        mel=(rng.normal(size=(B, t_mel, N_MELS)) * frames[..., None]).astype(np.float32),
        mel_lengths=mel_lens,
        aggregate_pitch=(rng.uniform(80, 300, (B, N)) * valid).astype(np.float32),
        aggregate_energy=(rng.uniform(0, 20, (B, N)) * valid).astype(np.float32),
        gate=(np.arange(t_mel)[None] >= mel_lens[:, None] - 1).astype(np.float32))
    return arrays


def _jin(arrays: dict):
    from speechflow_tpu.models.tts.data_types import TTSForwardInput as JaxInput

    names = {f.name for f in dataclasses.fields(JaxInput)}
    return jax_tts_input({k: v for k, v in arrays.items() if k in names})


def _tin(arrays: dict):
    return torch_tts_input({k: v for k, v in arrays.items() if k != "gate"})


def _targets(arrays: dict) -> dict:
    return {f.name: arrays.get(f.name) for f in dataclasses.fields(TTSTarget)}


def _pair(decoder: str):
    params = _params(decoder)
    jm = jax_tts_model(params)
    return jm, port(ParallelTTSModel(ParallelTTSParams.create(params)), jm)


def _criteria():
    from speechflow_tpu.models.tts import TTSCriterion as JCrit

    loss = configs("debug")[0]["loss"]
    return JCrit(**loss), TTSCriterion(**loss)


def _jax_target(arrays: dict):
    from speechflow_tpu.models.tts.data_types import TTSTarget as JTarget

    return JTarget(**{k: None if v is None else jnp.asarray(v)
                      for k, v in _targets(arrays).items()})


def _torch_target(arrays: dict) -> TTSTarget:
    return TTSTarget(**{k: None if v is None else t(v) for k, v in _targets(arrays).items()})


@pytest.mark.parametrize("decoder", ["wrapper", "cfm"])
def test_training_call_matches_jax(decoder):
    """Teacher-forced, deterministic: the stages' mel on valid frames, the gate,
    the variance predictions, the CFM loss and every loss of the criterion."""
    jm, tm = _pair(decoder)
    arrays = _batch()
    draws = cfm_train_draws(jm, B, arrays["mel"].shape)[0]
    ref = jm(_jin(arrays), training=True, deterministic=True)
    out = tm(_tin(arrays), training=True, deterministic=True, cfm_draws=draws)
    frames = np.arange(arrays["mel"].shape[1])[None] < arrays["mel_lengths"][:, None]
    np.testing.assert_array_equal(n(out.spectrogram_lengths), arrays["mel_lengths"])
    for stage in range(2):
        np.testing.assert_allclose(n(out.spectrogram[stage])[frames],
                                   n(ref.spectrogram[stage])[frames], atol=MODEL_TOL)
    np.testing.assert_allclose(n(out.gate)[frames], n(ref.gate)[frames], atol=MODEL_TOL)
    for name, pred in ref.variance_predictions.items():
        np.testing.assert_allclose(n(out.variance_predictions[name]), n(pred), atol=MODEL_TOL)
    assert set(out.additional_losses) == set(ref.additional_losses) == (
        {"cfm"} if decoder == "cfm" else set())
    jcrit, tcrit = _criteria()
    jl = jcrit(ref, _jax_target(arrays), jnp.asarray(0, jnp.int32))
    tl = tcrit(out, _torch_target(arrays), 0)
    assert set(tl) == set(jl) == {"spectral", "gate", "durations", "aggregate_pitch",
                                  "aggregate_energy"} | set(ref.additional_losses)
    for k in jl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]), rtol=MODEL_TOL, err_msg=k)


@pytest.mark.parametrize("decoder", ["wrapper", "cfm"])
def test_summed_loss_gradients_match_jax(decoder):
    """The gradient of every parameter: within ``GRAD_TOL`` of its tensor's
    largest magnitude (both sides take the plain attention path)."""
    jm, tm = _pair(decoder)
    arrays = _batch(1)
    draws = cfm_train_draws(jm, B, arrays["mel"].shape)[0]
    jcrit, tcrit = _criteria()
    jin, jtgt = _jin(arrays), _jax_target(arrays)

    def loss_fn(m):
        return sum(jcrit(m(jin, training=True, deterministic=True), jtgt,
                         jnp.asarray(0, jnp.int32)).values())

    jloss, jgrads = nnx.value_and_grad(loss_fn)(jm)
    ref = state_dict_from_nnx(tm, nnx.to_pure_dict(jgrads))
    out = tm(_tin(arrays), training=True, deterministic=True, cfm_draws=draws)
    loss = sum(tcrit(out, _torch_target(arrays), 0).values())
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=MODEL_TOL)
    model_scale = max(np.abs(n(r)).max() for r in ref.values())
    assert model_scale > 0
    for name, p in tm.named_parameters():
        g, r = n(p.grad) if p.grad is not None else np.zeros(p.shape), n(ref[name])
        scale = max(np.abs(r).max(), 1e-3 * model_scale)
        assert np.abs(g - r).max() <= GRAD_TOL * scale, name


@pytest.mark.parametrize("decoder", ["wrapper", "cfm"])
def test_fresh_weights_follow_flax_initialisers(decoder):
    """A model built from its params starts from the JAX model's distribution
    (``flax_init_``): in flax's layout, every tensor that is all zero or all one in
    the JAX model built from ``nnx.Rngs`` is so in the port's (biases, the zero
    modulations, norm scales, the fake CFG vectors); every other tensor's standard
    deviation is within 6/sqrt(size) of the JAX one's (six times the two draws'
    sampling error; torch's kaiming-uniform would be 0.58 of it, its N(0, 1)
    embeddings 1/std of it), and its mean within six standard errors of 0."""
    from speechflow_tpu.models.tts import ParallelTTSModel as J
    from speechflow_tpu.models.tts import ParallelTTSParams as JP

    params = _params(decoder)
    ref = flatten_nnx(nnx.to_pure_dict(nnx.state(J(JP.create(params), rngs=nnx.Rngs(0)),
                                                 nnx.Param)))
    torch.manual_seed(0)
    got = flatten_nnx(nnx_from_module(ParallelTTSModel(ParallelTTSParams.create(params))))
    assert set(got) == set(ref)
    drawn = 0
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, k
        if not r.any() or (r == 1).all():
            np.testing.assert_array_equal(g, r, err_msg=k)
            continue
        drawn += 1
        assert abs(g.std() / r.std() - 1) <= 6 / np.sqrt(r.size), k
        assert abs(g.mean()) <= 6 * g.std() / np.sqrt(r.size), k
    assert drawn > len(ref) // 3


def _jax_trainer(jm, opt: dict):
    from speechflow_tpu.models.tts import TTSBatchProcessor as JBP
    from speechflow_tpu.training import Trainer as JTrainer
    from speechflow_tpu.training.optimizer import OptimizerConfig as JOpt
    from speechflow_tpu.training.trainer import TrainerConfig as JCfg

    return JTrainer(jm, _criteria()[0], JBP(), JOpt.from_config(opt), JCfg(max_steps=10))


@pytest.mark.parametrize("decoder", ["wrapper", "cfm"])
def test_trainer_steps_match_jax(decoder, monkeypatch):
    """Two ``Trainer`` steps of the debug recipe's optimizer (AdamW on
    WarmupCosine, clip 1.0: the first step at lr 0 leaves the weights, the
    second moves them), every dropout rate 0: losses agree at each step, and
    the weights stay within two Adam steps of JAX's; then, for the CFM model,
    an SGD step at lr 1 (the update is the clipped gradient): the updates
    agree within ``GRAD_TOL`` of the largest."""
    jm, tm = _pair(decoder)
    no_dropout(jm, tm)
    batches = [_batch(2), _batch(3)]
    draws = iter(cfm_train_draws(jm, B, batches[0]["mel"].shape, n=3))
    monkeypatch.setattr(tm.decoder, "draw", lambda *a, **k: next(draws), raising=False)
    opt = configs("debug")[0]["optimizer"]
    jt = _jax_trainer(jm, opt)
    tt = Trainer(tm, _criteria()[1], TTSBatchProcessor(),
                 OptimizerConfig.from_config(opt), TrainerConfig(max_steps=10))
    before = flatten_nnx(nnx_from_module(tm))
    for i, arrays in enumerate(batches):
        a, b = jt.training_step(arrays), tt.training_step(CollatedTTS(**arrays))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=MODEL_TOL, err_msg=k)
        got = flatten_nnx(nnx_from_module(tm))
        if i == 0:
            assert all(np.array_equal(v, before[k]) for k, v in got.items())
    ref = flatten_nnx(nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
    assert any(not np.array_equal(v, before[k]) for k, v in got.items())
    for k in ref:
        assert np.abs(got[k] - ref[k]).max() <= 2 * LR, k
    if decoder == "wrapper":
        return  # the SGD step below once, on the CFM model
    sgd = dict(method="sgd", lr=1.0, lr_schedule="ConstLR", grad_clip=1.0, betas=(0.0, 0.999))
    jt = _jax_trainer(jm, sgd)
    tt = Trainer(tm, _criteria()[1], TTSBatchProcessor(),
                 OptimizerConfig.from_config(sgd), TrainerConfig(max_steps=10))
    load = {"model": nnx.to_pure_dict(nnx.state(jm, nnx.Param))}
    from speechflow_torch.convert import load_nnx_state

    load_nnx_state(tm, load["model"])  # both from JAX's weights
    before = flatten_nnx(nnx_from_module(tm))
    a, b = jt.training_step(batches[0]), tt.training_step(CollatedTTS(**batches[0]))
    np.testing.assert_allclose(float(b["total_loss"]), float(a["total_loss"]), rtol=MODEL_TOL)
    got, ref = flatten_nnx(nnx_from_module(tm)), flatten_nnx(
        nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
    scale = max(np.abs(ref[k] - before[k]).max() for k in ref)
    err = max(np.abs((got[k] - before[k]) - (ref[k] - before[k])).max() for k in ref)
    assert 0 < scale and err <= GRAD_TOL * scale, (err, scale)


def test_dropout_rates_follow_the_jax_model():
    """The rates the port builds: the encoder and postnet take ``dropout``, each
    variance predictor its ``VarianceConfig.dropout``, the duration predictor
    and the wrapper decoder's inner encoder their default 0.1 whatever
    ``dropout`` says, the DiT estimator 0."""
    from speechflow_tpu.models.tts import ParallelTTSModel as JModel
    from speechflow_tpu.models.tts import ParallelTTSParams as JParams

    def rates(model, kind):
        out = {}
        if kind == "jax":
            for path, node in nnx.iter_graph(model):
                name = ".".join(str(p) for p in path)
                if isinstance(node, nnx.Dropout):
                    out[name.rsplit(".dropout", 1)[0]] = node.rate
        else:
            for name, m in model.named_modules():
                if isinstance(getattr(m, "dropout", None), float) and not hasattr(m, "head_dim"):
                    out[name] = m.dropout
        return out

    for decoder in ("wrapper", "cfm"):
        params = _params(decoder)
        params["dropout"] = 0.3
        params["variances"][0]["dropout"] = 0.2
        jr = rates(JModel(JParams.create(params), rngs=nnx.Rngs(0)), "jax")
        tr = rates(ParallelTTSModel(ParallelTTSParams.create(params)), "torch")
        assert tr == pytest.approx(jr)
        assert {tr["encoder.blocks.0"], tr["postnet.blocks.0"],
                tr["variance_adaptor.predictors.aggregate_pitch.stack.blocks.0"],
                tr["variance_adaptor.predictors.durations.stack.blocks.0"]} == {0.3, 0.2, 0.1}
        if decoder == "wrapper":
            assert tr["decoder.enc.blocks.0"] == 0.1
        else:
            assert all(not k.startswith("decoder") for k in tr)
            assert {m.attn.dropout for m in
                    ParallelTTSModel(ParallelTTSParams.create(params)).decoder
                    .estimator.blocks} == {0.0}


def test_attention_switch_and_dropout(monkeypatch):
    """A training call (``deterministic=False``) takes the plain attention with
    weight dropout, never the fused path; a deterministic call takes the
    fused path; dropout changes the training call's output only when on."""
    calls = []
    real = A.fused_attention

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(A, "fused_attention", counting)
    jm, tm = _pair("cfm")
    arrays = _batch(4)
    draws = cfm_train_draws(jm, B, arrays["mel"].shape)[0]
    x = _tin(arrays)
    tm.train()
    torch.manual_seed(0)
    a = tm(x, cfm_draws=draws)
    assert not calls and a.additional_losses["cfm"].requires_grad
    torch.manual_seed(1)
    b = tm(x, cfm_draws=draws)
    assert not torch.equal(a.spectrogram, b.spectrogram)  # dropout 0.1 is on
    c = tm(x, deterministic=True, cfm_draws=draws)
    d = tm(x, deterministic=True, cfm_draws=draws)
    assert len(calls) == 2 * 2  # the encoder's two layers, twice; the CFM trains unfused
    torch.testing.assert_close(c.spectrogram, d.spectrogram, rtol=0, atol=0)
    w = A.attention_reference(*(torch.randn(2, 16, 2, 8) for _ in range(3)),
                              torch.ones(2, 16, dtype=torch.bool), dropout_rate=0.5)
    assert torch.isfinite(w).all()


def test_training_call_is_the_module_mode_and_needs_the_mel():
    """``training=None`` follows ``train()`` / ``eval()``: the generic trainer's
    ``model(inputs)`` trains, a serving caller's (eval mode) infers."""
    _, tm = _pair("wrapper")
    arrays = _batch(5)
    x = _tin(arrays)
    out = tm.train()(x)
    np.testing.assert_array_equal(n(out.spectrogram_lengths), arrays["mel_lengths"])
    assert out.spectrogram.shape[2] == arrays["mel"].shape[1]
    with torch.no_grad():
        inf = tm.eval()(x, t_out=40)
    assert inf.spectrogram.shape[2] == 40
    no_mel = _tin({k: v for k, v in arrays.items() if k != "mel"})
    with pytest.raises(ValueError, match="eval"):
        tm.train()(no_mel)


def test_validation_is_teacher_forced_with_dropout():
    """The port validates as JAX does (``_val_step`` calls ``model(inputs)``):
    the teacher-forced call with dropout on, without gradients. With the rates
    at 0 it gives the training step's losses; with dropout on, two calls on
    one batch differ."""
    jm, tm = _pair("wrapper")
    crit = _criteria()[1]
    arrays = _batch(6)
    tt = Trainer(tm, crit, TTSBatchProcessor(), OptimizerConfig(lr=0.0),
                 TrainerConfig(max_steps=10))
    torch.manual_seed(0)
    v1 = tt.validation_step(CollatedTTS(**arrays))
    v2 = tt.validation_step(CollatedTTS(**arrays))
    assert tm.training and all(p.grad is None for p in tm.parameters())
    assert set(v1) == {"spectral", "gate", "durations", "aggregate_pitch", "aggregate_energy",
                       "total_loss"}
    assert v1["spectral"] != v2["spectral"]
    no_dropout(jm, tm)
    v3 = tt.validation_step(CollatedTTS(**arrays))
    step = tt.training_step(CollatedTTS(**arrays))
    assert v3["total_loss"] == pytest.approx(float(step["total_loss"]), rel=1e-6)
    jv = _jax_trainer(jm, {"lr": 0.0}).validation_step(arrays)
    assert v3["total_loss"] == pytest.approx(jv["total_loss"], rel=MODEL_TOL)


def test_cfm_forward_train_draws_from_a_generator():
    """Without draws, u, z and the masks come from the generator: the same seed
    gives the same loss; the flow target and x_t follow the JAX formulas."""
    _, tm = _pair("cfm")
    dec = tm.decoder
    content = torch.randn(B, 24, dec.prior.in_features)
    lens = torch.tensor([24, 17])
    mel = torch.randn(B, 24, N_MELS)
    cond = torch.randn(B, dec.cond_dim)
    a = dec.forward_train(content, lens, mel, cond, generator=torch.Generator().manual_seed(3))
    b = dec.forward_train(content, lens, mel, cond, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a[1]["cfm"], b[1]["cfm"], rtol=0, atol=0)
    draws = dec.draw(B, mel.shape, mel.device, torch.Generator().manual_seed(3))
    c = dec.forward_train(content, lens, mel, cond, draws=draws)
    torch.testing.assert_close(a[1]["cfm"], c[1]["cfm"], rtol=0, atol=0)
    assert draws.drop_content.dtype == torch.bool and draws.drop_content.shape == (B, 1, 1)
    assert 0 <= float(draws.u.min()) and float(draws.u.max()) < 1


@pytest.mark.parametrize("schedule", [
    dict(scale=0.5),
    dict(scale=2.0, begin_iter=3, end_iter=9),
    dict(scale=1.0, every_iter=4),
    dict(scale=3.0, begin_iter=2, anneal_iters=5),
])
def test_loss_schedule_matches_jax(schedule):
    """``LossSchedule.gate`` at steps 0..11, and a spectral loss under it, as JAX's."""
    from speechflow_tpu.training.losses import LossSchedule as JSchedule
    from speechflow_tpu.training.losses.zoo import SpectralLoss as JSpectral

    from speechflow_torch.training.losses import LossSchedule, SpectralLoss

    ours, ref = LossSchedule(**schedule), JSchedule(**schedule)
    for step in range(12):
        assert ours.gate(step) == pytest.approx(float(ref.gate(jnp.asarray(step))), abs=1e-7)
    rng = np.random.default_rng(7)
    a, b = (rng.normal(size=(2, 2, 9, 4)).astype(np.float32) for _ in range(2))
    lens = np.array([9, 4])
    got = SpectralLoss(kind="l1", schedule=ours)(t(a), t(b[0]), step=5, lengths=t(lens))
    want = JSpectral(kind="l1", schedule=ref)(jnp.asarray(a), jnp.asarray(b[0]),
                                              step=jnp.asarray(5), lengths=jnp.asarray(lens))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("kind", ["l1", "l2", "huber"])
def test_criterion_options_match_jax(kind):
    """``TTSCriterion`` with per-loss schedules, a spectral kind and a scale on
    the model's additional loss, at steps 0..4, on random outputs: JAX's losses."""
    from speechflow_tpu.models.tts import TTSCriterion as JCrit
    from speechflow_tpu.models.tts.data_types import TTSOutput as JOut
    from speechflow_tpu.training.losses import LossSchedule as JSchedule

    from speechflow_torch.models.tts import TTSOutput
    from speechflow_torch.training.losses import LossSchedule

    rng = np.random.default_rng(8)
    arrays = _batch(9)
    out = {"spectrogram": rng.normal(size=(2,) + arrays["mel"].shape).astype(np.float32),
           "gate": rng.normal(size=arrays["gate"].shape).astype(np.float32)}
    preds = {k: rng.normal(size=(B, N)).astype(np.float32)
             for k in ("durations", "aggregate_pitch", "aggregate_energy")}
    cfm = np.float32(1.75)
    sched = dict(spectral=dict(scale=2.0, begin_iter=2), gate=dict(every_iter=2))
    kw = dict(spectral_kind=kind, variance_scales={"durations": 0.3, "aggregate_pitch": 0.01},
              additional_scales={"cfm": 0.5})
    ours = TTSCriterion(**kw, schedules={k: LossSchedule(**v) for k, v in sched.items()})
    ref = JCrit(**kw, schedules={k: JSchedule(**v) for k, v in sched.items()})
    tout = TTSOutput(**{k: t(v) for k, v in out.items()},
                     variance_predictions={k: t(v) for k, v in preds.items()},
                     additional_losses={"cfm": torch.tensor(cfm)})
    jout = JOut(**{k: jnp.asarray(v) for k, v in out.items()},
                variance_predictions={k: jnp.asarray(v) for k, v in preds.items()},
                additional_losses={"cfm": jnp.asarray(cfm)})
    for step in range(5):
        got = ours(tout, _torch_target(arrays), step)
        want = ref(jout, _jax_target(arrays), jnp.asarray(step, jnp.int32))
        assert set(got) == set(want) == {"spectral", "gate", "durations", "aggregate_pitch",
                                         "cfm"}
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} at step {step}")
