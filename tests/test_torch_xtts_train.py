"""XTTS training in the port against the JAX package (f32, CPU).

- the fused-attention VJP (``ops.attention.fused_attention_vjp``, the backward
  of the CUDA wrapper) against JAX's ``_fused_attention_bwd`` called on the same
  residuals, and against PyTorch autograd of the plain version;
- ``TTSCollateWithPrompt`` bit for bit on samples of the repo's corpus;
- one XTTS training step (identical codes, ``gpt_ce``, every gradient, then the
  parameters after one AdamW step, codec included), both block types;
- ``codec_criterion`` and a codec training step's gradients;
- ``filter_state_by_prefix`` / ``merge_states``;
- ``train_tts`` on the XTTS recipe (debug) on the CPU, then resume, finetune
  and warm start from its checkpoint, and ``XTTSEvaluationInterface`` and an
  ``InferenceBundle`` on it;
- the XTTS recipe's presets against ``configs/xtts_model.yml``.

Widths are the recipe's debug ones; weights are seeded (``tests/torch_parity.py``)
and copied with ``speechflow_torch.convert``. Tolerances are stated at each test.
"""

import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch import serving
from speechflow_torch.convert import flatten_nnx, nnx_from_module, state_dict_from_nnx
from speechflow_torch.data.collate import CollatedTTS, TTSCollateWithPrompt
from speechflow_torch.data.core.components import DataPipeline
from speechflow_torch.interface.xtts_interface import XTTSEvaluationInterface
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.models.codec import CodecParams, NeuralCodec, codec_criterion
from speechflow_torch.models.tts import (
    XTTSBatchProcessor,
    XTTSModel,
    XTTSParams,
    xtts_criterion,
)
from speechflow_torch.ops import attention as A
from speechflow_torch.scripts import train_tts
from speechflow_torch.scripts.common import (
    apply_resume_warmstart,
    build_data,
    source_checkpoint,
)
from speechflow_torch.training.optimizer import OptimizerConfig
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.training.trainer import Trainer, TrainerConfig
from tests.torch_parity import n, port, randomize, t

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
SEGS = REPO / "tests" / "data" / "SEGS"
XTTS_DEBUG = train_tts.configs("debug", "configs/xtts_model.yml")[0]["model"]
VJP_TOL = 1e-5      # the attention VJP against JAX's, absolute (inputs and cotangent ~N(0, 1))
LOSS_TOL = 1e-5     # gpt_ce, relative
GRAD_TOL = 2e-4     # each gradient, of its tensor's largest magnitude (see _grad_errors)
STEP_TOL = 1e-6     # parameters after one AdamW step, of each tensor's largest magnitude
STFT_GRAD_TOL = 1e-3  # gradients through the STFT loss (see the codec's test)
N_MELS = serving.TTS_DATA_CONFIG["preproc"]["pipe_cfg"]["linear_to_mel"]["n_mels"]


def _rng(seed=0):
    return np.random.default_rng(seed)


# -- the attention VJP ----------------------------------------------------------------


def _attention_case(dh: int, seed: int = 0):
    """(B, T, H, dh) q, k, v and a cotangent ~N(0, 1); keys and queries padded (the
    second row's last 29 positions), with 1e4-scale values in the padded rows."""
    b, t_len, h = 2, 77, 2
    rng = _rng(seed)
    q, k, v, g = (rng.normal(size=(b, t_len, h, dh)).astype(np.float32) for _ in range(4))
    valid = np.ones((b, t_len), bool)
    valid[1, 48:] = False
    for x in (q, k, v):
        x[~valid] = 1e4 * rng.normal(size=x[~valid].shape)
    return q, k, v, valid, g


def _heads_first(x, h):
    """(B, T, H, dh) -> (B·H, T, dh), the JAX wrapper's layout."""
    b, t_len = x.shape[:2]
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, t_len, -1))


@pytest.mark.parametrize("dh", [128, 256])
def test_attention_vjp_matches_jax(dh):
    """``fused_attention_vjp`` against ``_fused_attention_bwd`` on the same residuals.
    JAX zeroes padded query rows after ``_fused_attention`` (``flash_attention_fn``),
    so the cotangent that reaches its VJP is already zero there; the port's kernel
    zeroes them inside, and its VJP gets the raw cotangent. dq, dk, dv within
    ``VJP_TOL``; padded rows of dk and dv are zero."""
    from speechflow_tpu.ops.attention import _fused_attention_bwd

    q, k, v, valid, g = _attention_case(dh)
    h = q.shape[2]
    vh = np.repeat(valid.astype(np.float32), h, axis=0)
    gh = _heads_first(g, h) * vh[..., None]
    ref = _fused_attention_bwd(tuple(jnp.asarray(_heads_first(x, h)) for x in (q, k, v))
                               + (jnp.asarray(vh),), jnp.asarray(gh))
    got = A.fused_attention_vjp(t(q), t(k), t(v), t(valid), t(g))
    for name, a, r in zip("qkv", got, ref[:3]):
        a = _heads_first(n(a), h)
        err = np.abs(a - np.asarray(r)).max()
        assert err <= VJP_TOL, f"d{name}: {err}"
    assert not n(got[1])[~valid].any() and not n(got[2])[~valid].any()
    assert not np.asarray(ref[3]).any()


@pytest.mark.parametrize("dh", [128, 256])
def test_attention_vjp_is_autograd_of_the_plain_version(dh):
    """The CPU path (``attention_reference`` under autograd, with padded query rows
    zeroed in its output) has the VJP's gradient: within 1e-6 of each gradient's
    largest magnitude."""
    q, k, v, valid, g = _attention_case(dh, seed=1)
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    out = A.fused_attention(*leaves, t(valid))
    out.backward(t(g))
    got = A.fused_attention_vjp(t(q), t(k), t(v), t(valid), t(g))
    for name, leaf, a in zip("qkv", leaves, got):
        scale = leaf.grad.abs().max().item()
        assert scale > 0 and (a - leaf.grad).abs().max().item() <= 1e-6 * scale, name


# -- the prompt collate -----------------------------------------------------------------


@pytest.fixture(scope="module")
def processed_samples():
    """The debug data config's first three train utterances through every handler,
    in both packages (the same files; their collated batches are equal,
    ``tests/test_torch_tts_data.py``)."""
    from speechflow_tpu.data.core.components import DataPipeline as JDP
    from speechflow_tpu.io import Config

    _, data_cfg = train_tts.configs("debug", data_root=SEGS)
    ours = DataPipeline.from_config(data_cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SFTPU_DUMP_CACHE", raising=False)
        theirs = JDP(Config(data_cfg)).init_components()
    mine = [s.copy() for s in ours.datasets["train"][:3]]
    ref = [s.copy() for s in list(theirs["train"].dataset)[:3]]
    assert [s.file_path for s in mine] == [s.file_path for s in ref]
    processed = []
    for ds in mine:
        for fn in ours.preproc_fns:
            ds = fn(ds)
        processed.append(ds)
    return processed, list(theirs["train"].datasample_to_batch(ref).data_samples)


@pytest.mark.parametrize("rows,speakers", [
    ((0, 1, 2, 0), (3, 5, 3, 7)),        # a pair, two speakers alone (prompt = self)
    ((2, 1, 0), (4, 4, 4)),              # one speaker: each row's first other row
    ((1,), (0,)),                        # a single row
    ((0, 2, 1, 1, 2), (1, 2, 2, 1, 2)),  # interleaved
])
def test_collate_with_prompt_matches_jax(processed_samples, rows, speakers):
    """Fixed lists of processed samples with given speaker ids through both
    ``TTSCollateWithPrompt``s: every field and every ``additional`` entry equal,
    dtype and all; the prompt of each row is the first other row of its speaker."""
    from speechflow_tpu.data.collate import TTSCollateWithPrompt as J

    batches = []
    for samples in processed_samples:
        chosen = []
        for r, spk in zip(rows, speakers):
            s = samples[r].copy()
            s.speaker_id = spk
            chosen.append(s)
        batches.append(chosen)
    got, want = TTSCollateWithPrompt()(batches[0]), J()(batches[1])
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "additional":
            assert set(a) == set(b) == {"prompt_index", "prompt_mel", "prompt_mel_lengths",
                                        "prompt_transcription"}
            for key in a:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        elif b is None:
            assert a is None, f.name
        else:
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    expect = [next((j for j, s in enumerate(speakers) if s == spk and j != i), i)
              for i, spk in enumerate(speakers)]
    np.testing.assert_array_equal(got.additional["prompt_index"], expect)


# -- one XTTS training step ----------------------------------------------------------------


def _cfg(block_type: str, **kw) -> dict:
    """The debug recipe with 2 GPT layers, a prompt of the data config's mel bins,
    40 symbols and 3 speakers."""
    c = dict(XTTS_DEBUG, n_layers=2, n_symbols=40, n_speakers=3,
             prompt_dim=N_MELS, block_type=block_type)
    c.update(kw)
    return c


def _pair(cfg: dict, seed: int = 0):
    from speechflow_tpu.models.tts.xtts import XTTSModel as JX
    from speechflow_tpu.models.tts.xtts import XTTSParams as JP

    jm = randomize(JX(JP.create(cfg), rngs=nnx.Rngs(0)), seed)
    return jm, port(XTTSModel(XTTSParams.create(cfg)), jm).train()


def _xtts_batch(seed: int = 12) -> dict:
    """A collated batch's fields: ragged waveforms (2 x 4096 samples, 16 codec
    frames), text, speakers and a ragged prompt (24 and 9 mel frames)."""
    rng = _rng(seed)
    return {"transcription": rng.integers(1, 40, (2, 16)).astype(np.int32),
            "waveform": (0.3 * rng.normal(size=(2, 4096))).astype(np.float32),
            "waveform_lengths": np.array([4096, 2500], np.int32),
            "speaker_id": np.array([0, 2], np.int32),
            "additional": {"prompt_mel": rng.normal(size=(2, 24, N_MELS)).astype(np.float32),
                           "prompt_mel_lengths": np.array([24, 9], np.int32)}}


def _grad_errors(got: dict, ref: dict) -> dict:
    """Each gradient's error relative to its tensor's largest magnitude, or to 1e-3
    of the model's largest gradient where that is more."""
    model_scale = max(np.abs(r).max() for r in ref.values())
    assert model_scale > 0
    return {k: np.abs(got[k] - r).max() / max(np.abs(r).max(), 1e-3 * model_scale)
            for k, r in ref.items()}


@pytest.mark.parametrize("block_type", ["attention", "retention"])
def test_xtts_training_step_matches_jax(block_type):
    """The teacher-forced call and one ``Trainer`` step of both packages on one
    batch: the codes the codecs encode identical; ``gpt_ce`` within ``LOSS_TOL``
    relative; every gradient within ``GRAD_TOL`` of its scale, none of JAX's all
    zero but the codec's (it is reached through integer codes only); then one
    AdamW step (the recipe's lr 1e-3, constant; clip 1.0; weight decay 0.1, so the
    codec's decay-only update p·(1 - lr·wd) is 100x ``STEP_TOL``): each parameter
    within ``STEP_TOL`` of its tensor's scale of JAX's, beyond the part of the
    difference that the two gradients' own difference makes in the step.

    That part: AdamW's first step moves an element by lr·u(g), u(g) = ĝ/(|ĝ| + ε)
    (ĝ the clipped gradient, ε = 1e-8), so where a gradient is ~ε, rounding-level
    in both packages, the move is set by that rounding (up to 2.4e-3·lr apart in
    this model for gradients that agree to 7e-7 of their scale; up to lr·2 for the
    attention key biases, whose true gradient is 0, softmax being shift-invariant).
    Each element's allowance is lr·|u(g_port) - u(g_jax)|, in f64, from the port's
    gradient and JAX's as its trainer's compiled step computes it (an eager call
    rounds otherwise)."""
    from speechflow_tpu.models.tts.xtts import XTTSBatchProcessor as JBP
    from speechflow_tpu.models.tts.xtts import xtts_criterion as jcrit
    from speechflow_tpu.training import Trainer as JTrainer
    from speechflow_tpu.training.optimizer import OptimizerConfig as JOpt
    from speechflow_tpu.training.trainer import TrainerConfig as JCfg

    jm, tm = _pair(_cfg(block_type))
    arrays = _xtts_batch()
    jin, _ = JBP()(arrays)
    jin = {k: None if v is None else jnp.asarray(v) for k, v in jin.items()}
    tin, _ = XTTSBatchProcessor()(CollatedTTS(**arrays))
    assert set(tin) == set(jin)
    np.testing.assert_array_equal(n(tm.codec.encode(tin["waveform"])),
                                  np.asarray(jm.codec.encode(jin["waveform"])))

    jloss, jgrads = nnx.value_and_grad(lambda m: m(jin)["gpt_ce"])(jm)
    loss = tm(tin)["gpt_ce"]
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    ref = {k: n(v) for k, v in state_dict_from_nnx(tm, nnx.to_pure_dict(jgrads)).items()}
    got = {k: np.zeros(p.shape, np.float32) if p.grad is None else n(p.grad)
           for k, p in tm.named_parameters()}
    errs = _grad_errors(got, ref)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    zero = [k for k, r in ref.items() if not r.any()]
    assert zero and all(k.startswith("codec.") for k in zero), zero
    assert all(not r.any() for k, r in ref.items() if k.startswith("codec."))
    # both gradients in the JAX layout, keyed by its dotted paths; JAX's as its
    # trainer's compiled step computes them (its rounding differs from the eager call's)
    jg = flatten_nnx(nnx.to_pure_dict(nnx.jit(lambda m, x: nnx.grad(
        lambda mm: jcrit()(mm(x), {}, 0)["gpt_ce"])(m))(jm, jin)))
    with torch.no_grad():
        for p in tm.parameters():
            p.data, p.grad = (torch.zeros_like(p) if p.grad is None else p.grad), p.data
        tg = flatten_nnx(nnx_from_module(tm))
        for p in tm.parameters():
            p.data, p.grad = p.grad, None

    lr, wd, eps = 1e-3, 0.1, 1e-8
    opt = dict(method="adamw", lr=lr, lr_schedule="ConstLR", grad_clip=1.0, weight_decay=wd,
               eps=eps)
    jt = JTrainer(jm, jcrit(), JBP(), JOpt.from_config(opt), JCfg(max_steps=10))
    tt = Trainer(tm, xtts_criterion(), XTTSBatchProcessor(), OptimizerConfig.from_config(opt),
                 TrainerConfig(max_steps=10))
    before = flatten_nnx(nnx_from_module(tm))
    a, b = jt.training_step(arrays), tt.training_step(CollatedTTS(**arrays))
    assert abs(float(b["gpt_ce"]) - float(a["gpt_ce"])) <= LOSS_TOL * abs(float(a["gpt_ce"]))
    after = flatten_nnx(nnx_from_module(tm))
    want = flatten_nnx(nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
    assert set(after) == set(want) == set(jg) == set(tg)

    def first_step(grads):
        g = {k: v.astype(np.float64) for k, v in grads.items()}
        norm = math.sqrt(sum(float((v ** 2).sum()) for v in g.values()))
        c = 1.0 if norm < 1.0 else 1.0 / norm
        return {k: c * v / (np.abs(c * v) + eps) for k, v in g.items()}

    u_port, u_jax = first_step(tg), first_step(jg)
    for k, w in want.items():
        assert not np.array_equal(w, before[k]), k  # every tensor moved, the codec's too
        excess = np.abs(after[k] - w) - lr * np.abs(u_port[k] - u_jax[k])
        assert excess.max() <= STEP_TOL * np.abs(w).max(), (k, excess.max())
    codec = [k for k in want if k.startswith("codec.")]
    assert codec
    for k in codec:  # decay only: p·(1 - lr·wd)
        np.testing.assert_allclose(after[k], before[k] * (1 - lr * wd), rtol=1e-6, atol=0)


# -- the codec's training ------------------------------------------------------------------


def test_codec_criterion_and_gradients_match_jax():
    """The codec's training forward and ``codec_criterion`` (L1, multi-resolution
    STFT, VQ) on waveforms of 2 x 3000 samples: identical codes; each loss within
    1e-5 relative; every gradient of L1 + VQ within ``GRAD_TOL`` of its scale, and
    of the codec's backward from one cotangent (JAX's gradient of the whole
    criterion at its reconstruction) too; the whole criterion's within
    ``STFT_GRAD_TOL``, none all zero.

    The STFT term's log(|X| + 1e-5) multiplies the two packages' FFT rounding in
    bins of small magnitude (its gradient at one and the same reconstruction
    differs by 4.5e-5 of its scale; through the codec's parameters, from
    reconstructions 3.6e-7 apart, by up to 4.6e-4): its tolerance is the one
    ``tests/test_torch_train_ops.py`` holds that loss's gradient to."""
    from speechflow_tpu.models.codec import CodecParams as JCP
    from speechflow_tpu.models.codec import NeuralCodec as JNC
    from speechflow_tpu.models.codec.rvq import codec_criterion as jcc

    cfg = XTTS_DEBUG["codec"]
    jc = randomize(JNC(JCP.create(cfg), rngs=nnx.Rngs(0)), 4)
    tc = port(NeuralCodec(CodecParams.create(cfg)), jc).train()
    wav = (0.3 * _rng(13).normal(size=(2, 3000))).astype(np.float32)
    jwav, twav = jnp.asarray(wav), t(wav)
    jcrit_fn, tcrit_fn = jcc(), codec_criterion()

    def jax_grads(terms):
        def loss_fn(m):
            losses = jcrit_fn(m(jwav), {"waveform": jwav}, 0)
            return sum(losses[k] for k in terms), losses
        (_, losses), grads = nnx.value_and_grad(loss_fn, has_aux=True)(jc)
        return losses, {k: n(v) for k, v in
                        state_dict_from_nnx(tc, nnx.to_pure_dict(grads)).items()}

    def port_grads(terms=None, cotangent=None):
        tc.zero_grad(set_to_none=True)
        out = tc(twav)
        losses = tcrit_fn(out, {"waveform": twav}, 0)
        total = (out[0] * t(cotangent)).sum() if cotangent is not None else sum(
            losses[k] for k in terms)
        total.backward()
        return out, losses, {k: np.zeros(p.shape, np.float32) if p.grad is None else n(p.grad)
                             for k, p in tc.named_parameters()}

    def worst(got, ref):
        errs = _grad_errors(got, ref)
        k = max(errs, key=errs.get)
        return errs[k], k

    jl, ref = jax_grads(("l1", "stft", "vq"))
    out, tl, got = port_grads(("l1", "stft", "vq"))
    np.testing.assert_array_equal(n(out[1]), np.asarray(jc.encode(jwav)))
    assert set(tl) == set(jl) == {"l1", "stft", "vq"}
    for k in jl:
        assert abs(tl[k].item() - float(jl[k])) <= 1e-5 * abs(float(jl[k])), k
    assert all(r.any() for r in ref.values())
    err, where = worst(got, ref)
    assert err <= STFT_GRAD_TOL, (where, err)

    err, where = worst(port_grads(("l1", "vq"))[2], jax_grads(("l1", "vq"))[1])
    assert err <= GRAD_TOL, (where, err)

    recon = jc(jwav)[0]
    cot = jax.grad(lambda r: sum(jcrit_fn((r, None, jc(jwav)[2]), {"waveform": jwav},
                                          0).values()))(recon)
    ref_vjp = nnx.grad(lambda m: jnp.sum(m(jwav)[0] * cot))(jc)
    ref_vjp = {k: n(v) for k, v in state_dict_from_nnx(tc, nnx.to_pure_dict(ref_vjp)).items()}
    err, where = worst(port_grads(cotangent=np.asarray(cot))[2], ref_vjp)
    assert err <= GRAD_TOL, (where, err)


# -- warm starts -----------------------------------------------------------------------------


def _tree():
    rng = _rng(14)
    return {"gpt": {"blocks": {0: {"attn": {"kernel": rng.normal(size=(4, 4))}},
                               1: {"attn": {"kernel": rng.normal(size=(4, 4))}}},
                    "head": {"kernel": rng.normal(size=(4, 6)), "bias": rng.normal(size=6)}},
            "codec": {"enc_pre": {"kernel": rng.normal(size=(7, 1, 8))}},
            "speaker_emb": {"embedding": rng.normal(size=(3, 2))}}


@pytest.mark.parametrize("include,exclude", [
    ((), ()), (("gpt",), ()), (("gpt",), ("head",)), ((), ("codec",)),
    (("blocks/1", "speaker"), ()), (("nothing",), ()),
])
def test_filter_and_merge_states_match_jax(include, exclude):
    """Both packages' ``filter_state_by_prefix`` on one nested dict (digit keys as
    ints, as pure dicts hold list indices), then ``merge_states`` onto another
    (one leaf of another shape, which keeps the target's): equal trees."""
    from speechflow_tpu.training.saver import ExperimentSaver as JS

    src, target = _tree(), _tree()
    target["gpt"]["head"]["bias"] = np.zeros(7)
    for tree in (src, target):
        tree["gpt"]["blocks"][1]["attn"]["kernel"] += 1.0 if tree is src else 0.0
    got = ExperimentSaver.filter_state_by_prefix(src, include, exclude)
    want = JS.filter_state_by_prefix(src, include, exclude)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    merged, ref = (ExperimentSaver.merge_states(target, got), JS.merge_states(target, want))
    assert jax.tree_util.tree_structure(merged) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(merged), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    assert merged["gpt"]["head"]["bias"].shape == (7,)


# -- the training entry point ----------------------------------------------------------------


def _quick(model_cfg: dict, max_steps: int, **sections) -> dict:
    """The debug XTTS recipe at ``max_steps``, loading in this process."""
    model_cfg = dict(model_cfg, data_loaders={"n_workers": 0, "prefetch_factor": 2},
                     trainer=dict(model_cfg["trainer"], max_steps=max_steps), **sections)
    return model_cfg


@pytest.fixture(scope="module")
def xtts_run(tmp_path_factory):
    """``train_tts.main`` on the XTTS recipe (debug) for 2 steps on the CPU."""
    out = tmp_path_factory.mktemp("xtts_run")
    expr = train_tts.main(["-c", "configs/xtts_model.yml", "-vs", "debug", "--max_steps", "2",
                           "--device", "cpu", "--experiment_dir", str(out),
                           "--data_root", str(SEGS)])
    return Path(expr)


def test_train_tts_trains_xtts_on_the_cpu(xtts_run):
    """The checkpoint holds the XTTS params (prompt bins from the pipeline's mel
    config, the recipe's widths) and the pipeline info of the prompt collate; the
    data config's text says TTSCollate, as the JAX script leaves it."""
    ckpt = ExperimentSaver.get_last_checkpoint(xtts_run)
    tree, payload = ExperimentSaver.load_checkpoint(ckpt)
    assert ckpt.name == "step_000000002" and tree["opt"]["count"] == 2
    params = payload["model_params"]
    info = payload["pipeline_info"]
    assert params["prompt_dim"] == info["config"]["preproc"]["pipe_cfg"]["linear_to_mel"][
        "n_mels"] == 80
    assert params["n_symbols"] == len(info["alphabet"]["symbols"])
    assert params["dim"] == 48 and params["use_prompt"] and "n_langs" not in params
    assert info["config"]["collate"]["type"] == "TTSCollateWithPrompt"
    assert "type: TTSCollate\n" in payload["data_config_text"]
    assert set(tree["model"]) == {"codec", "gpt", "speaker_emb", "prompt_enc"}


def test_resume_finetune_and_warmstart_from_an_xtts_run(xtts_run, tmp_path):
    """From the run's checkpoint: ``resume.from`` continues at step 2 with its
    optimizer; ``finetune.ckpt`` starts a fresh optimizer from its weights;
    ``warmstart.ckpt`` with ``include: [gpt]`` takes the GPT's weights and leaves
    the rest as initialised (the recipe's warmup makes the first step's lr 0, so
    the weights after it are those it started from)."""
    ckpt = ExperimentSaver.get_last_checkpoint(xtts_run)
    src = flatten_nnx(ExperimentSaver.load_checkpoint(ckpt)[0]["model"])
    model_cfg, data_cfg = train_tts.configs("debug", "configs/xtts_model.yml", data_root=SEGS)
    runs = {"resume": _quick(model_cfg, 3, resume={"from": str(xtts_run)}),
            "finetune": _quick(model_cfg, 1, finetune={"ckpt": str(ckpt)}),
            "warmstart": _quick(model_cfg, 1, warmstart={"ckpt": str(ckpt),
                                                         "include": ["gpt"]}),
            "fresh": _quick(model_cfg, 1)}
    first = {}
    for name, cfg in runs.items():
        seen = []

        def callback(trainer, last, seen=seen):
            if not seen:
                seen.append((trainer.global_step, trainer.optimizer.count,
                             flatten_nnx(nnx_from_module(trainer.model))))

        saver = ExperimentSaver(tmp_path / name, expr_suffix=name)
        train_tts.train(cfg, data_cfg, saver, device="cpu", callbacks=[callback])
        first[name] = seen[0]
    assert first["resume"][:2] == (3, 3)
    assert first["finetune"][:2] == first["warmstart"][:2] == (1, 1)
    fine, warm, fresh = (first[k][2] for k in ("finetune", "warmstart", "fresh"))
    moved = [k for k in src if not np.array_equal(src[k], fresh[k])]
    assert any(k.startswith("gpt.") for k in moved) and any(
        k.startswith("prompt_enc.") for k in moved)
    for k, v in src.items():
        np.testing.assert_array_equal(fine[k], v, err_msg=k)
        np.testing.assert_array_equal(warm[k], v if k.startswith("gpt.") else fresh[k],
                                      err_msg=k)


@pytest.mark.parametrize("kind", ["resume", "finetune", "warmstart"])
def test_a_started_run_keeps_the_checkpoints_speaker_ids(xtts_run, kind):
    """``build_data`` on another corpus (the Russian speakers only) seeds the
    speaker map from the checkpoint the run starts from, as JAX's
    ``_resume_singletons``: the checkpoint's ids stay, a new speaker is appended
    (JAX's ``SpeakerIDSetter`` seeded and fitted on the same samples gives the same
    map); a fresh start on that corpus numbers its speakers anew."""
    from speechflow_tpu.data.core.singleton import Singleton
    from speechflow_tpu.data.processors.singletons import SpeakerIDSetter as JS

    ckpt = ExperimentSaver.get_last_checkpoint(xtts_run)
    seed = ExperimentSaver.load_payload(ckpt)["pipeline_info"]["singletons"]
    model_cfg, data_cfg = train_tts.configs("debug", "configs/xtts_model.yml")
    data_cfg["dirs"]["data_root"] = str(REPO / "tests" / "data" / "SEGS" / "RU")
    source = {"resume": {"from": str(xtts_run)}, "finetune": {"ckpt": str(ckpt)},
              "warmstart": {"ckpt": str(ckpt), "include": ["gpt"]}}[kind]
    maps = {}
    for name, cfg in (("started", _quick(model_cfg, 1, **{kind: source})),
                      ("fresh", _quick(model_cfg, 1))):
        pipeline, loaders = build_data(data_cfg, cfg)
        for ld in loaders.values():
            ld.close()
        maps[name] = pipeline.get_info()["singletons"]["SpeakerIDSetter"]
    Singleton.clear(JS)
    try:
        want = JS()
        want.load_state_dict(seed["SpeakerIDSetter"])
        want.fit(pipeline.datasets["train"])
    finally:
        Singleton.clear(JS)
    old = seed["SpeakerIDSetter"]["speaker2id"]
    assert maps["started"] == want.state_dict()
    assert {k: maps["started"]["speaker2id"][k] for k in old} == old
    assert set(maps["started"]["speaker2id"]) > set(old)
    assert maps["fresh"] != maps["started"]


def test_finetune_and_warmstart_take_a_checkpoint_directory(xtts_run):
    """``finetune.ckpt`` and ``warmstart.ckpt`` name a checkpoint, as in JAX; an
    experiment directory is refused before anything is built."""
    for kind in ("finetune", "warmstart"):
        with pytest.raises(FileNotFoundError, match=f"{kind}.ckpt"):
            source_checkpoint({kind: {"ckpt": str(xtts_run)}})
    assert source_checkpoint({}) == (None, None)


def test_warmstart_keeps_the_target_where_shapes_differ(xtts_run):
    """A warm start from a checkpoint of another vocabulary: the tensors of another
    shape keep the fresh model's values, the rest are loaded."""
    ckpt = ExperimentSaver.get_last_checkpoint(xtts_run)
    _, payload = ExperimentSaver.load_checkpoint(ckpt)
    torch.manual_seed(1)
    model = XTTSModel(XTTSParams.create(dict(payload["model_params"],
                                             n_symbols=payload["model_params"]["n_symbols"] + 3)))
    fresh = flatten_nnx(nnx_from_module(model))
    trainer = Trainer(model, xtts_criterion(), XTTSBatchProcessor())
    apply_resume_warmstart(trainer, {"warmstart": {"ckpt": str(ckpt)}})
    got = flatten_nnx(nnx_from_module(model))
    src = flatten_nnx(ExperimentSaver.load_checkpoint(ckpt)[0]["model"])
    differ = [k for k in src if src[k].shape != fresh[k].shape]
    assert differ == ["gpt.text_emb.embedding"]
    for k in src:
        np.testing.assert_array_equal(got[k], fresh[k] if k in differ else src[k], err_msg=k)


def test_xtts_interface_loads_a_trained_checkpoint(xtts_run, tmp_path):
    """``XTTSEvaluationInterface`` on the checkpoint ``train_tts`` wrote (the real
    pipeline info: the phoneme alphabet, the corpus's speakers, the mel config),
    directly and packed into an ``InferenceBundle`` (``--xtts <run>``): a request with
    a reference prompt gives a finite waveform of its tokens' hops, the same through
    both at temperature 0."""
    from speechflow_torch.scripts.export import InferenceBundle, pack

    xi = XTTSEvaluationInterface(ExperimentSaver.get_last_checkpoint(xtts_run), device="cpu")
    assert xi.params.prompt_dim == 80 and xi.get_speakers()
    ref = AudioChunk(data=(0.1 * _rng(15).normal(size=12000)).astype(np.float32), sr=24000)
    bundle = InferenceBundle.load(pack(tmp_path / "bundle.tar.gz", xtts=xtts_run), device="cpu")
    outs = [iface.synthesize("Hello world.", speaker=xi.get_speakers()[0], max_tokens=6,
                             temperature=0.0, ref_audio=ref) for iface in (xi, bundle.xtts)]
    for out in outs:
        assert out.data.shape == (6 * 256,) and np.isfinite(out.data).all()
    np.testing.assert_array_equal(outs[0].data, outs[1].data)


def test_recipe_selection(tmp_path, monkeypatch):
    """``-c`` and ``-cd`` take any YAML file on disk: a copy of the XTTS recipe
    outside the repository, with a selector of its own, picks the XTTS model
    (the run is cut where training would start); a missing file raises."""
    text = (REPO / "configs" / "xtts_model.yml").read_text()
    mine = tmp_path / "my_xtts.yml"
    mine.write_text(text.replace("dim: {default: 1024, debug: 48}",
                                 "dim: {default: 1024, debug: 48, mine: 32}"))
    seen = {}

    def fake_train(model_cfg, data_cfg, saver, **kw):
        seen.update(model=model_cfg, data=data_cfg, expr=saver.expr_path)
        return str(saver.expr_path)

    monkeypatch.setattr(train_tts, "train", fake_train)
    train_tts.main(["-c", str(mine), "-cd", str(REPO / "configs" / "tts_data_24khz.yml"),
                    "-vs", "mine", "debug", "--experiment_dir", str(tmp_path / "exp")])
    assert seen["model"]["model"]["type"] == "xtts" and seen["model"]["model"]["dim"] == 32
    assert seen["model"]["batch"]["size"] == 2  # "debug", the second selector
    assert (seen["expr"] / "model.yml").read_text().startswith("experiment:")
    assert not hasattr(train_tts, "recipe_of")
    with pytest.raises(FileNotFoundError):
        train_tts.main(["-c", str(tmp_path / "missing.yml")])
