"""The forced-aligner recipes of the port against the JAX package (f32, CPU):
the flows (forward, reverse, invertibility, log-determinant), ``Inv1x1Conv``'s
initial rotation bit for bit, the ``GlowTTSAligner``'s outputs with durations
exact, ``AlignerCriterion``, ``generate`` with JAX's noise, one training step,
the stage-1 handlers (``phonemize``, ``add_pauses_from_text``) and the aligner
data pipeline over the SEGS raw grids, the TextGrid writer's text, and the
port's ``Aligner`` over a checkpoint the JAX ``train_aligner`` writes: the same
``.TextGridStage1`` intervals as the JAX ``Aligner``.

Tolerances: tensors within 1e-4 of the reference's largest magnitude
(``TOL_REL``), losses within 1e-5 relative; the MAS path, the durations and
the emitted labels exactly; emitted times within 1e-6 s (the writer's six
decimals)."""

import copy
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.models.aligner import AlignerCriterion, GlowTTSAligner, GlowTTSParams
from speechflow_torch.models.aligner.flows import FlowSpecDecoder, Inv1x1Conv
from tests.torch_parity import n, no_dropout, port, randomize, t

torch.set_num_threads(1)
TOL_REL = 1e-4
REPO = Path(__file__).resolve().parent.parent
SEGS = REPO / "tests" / "data" / "SEGS"
PARAMS = dict(n_symbols=20, n_speakers=2, n_langs=2, n_mels=8, encoder_dim=16,
              encoder_layers=2, encoder_heads=2, n_flows=2, flow_hidden=8,
              speaker_emb_dim=4, lang_emb_dim=2)


def close(got, ref, tol: float = TOL_REL):
    got, ref = n(got), n(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= tol * scale, (np.abs(got - ref).max(), scale)


def batch(rng, b: int = 3, n_tok: int = 7, frames: int = 41) -> dict:
    tok_lens = np.asarray([n_tok, 5, 4][:b], np.int32)
    mel_lens = np.asarray([frames, 30, 17][:b], np.int32)
    valid = np.arange(n_tok)[None] < tok_lens[:, None]
    return dict(
        transcription=np.where(valid, rng.integers(5, 20, (b, n_tok)), 0).astype(np.int32),
        transcription_lengths=tok_lens,
        mel=rng.normal(size=(b, frames, 8)).astype(np.float32),
        mel_lengths=mel_lens,
        speaker_id=rng.integers(0, 2, (b,)).astype(np.int32),
        lang_id=rng.integers(0, 2, (b,)).astype(np.int32))


def inputs(a: dict, jax_side: bool):
    if jax_side:
        from speechflow_tpu.models.tts.data_types import TTSForwardInput as J

        return J(**{k: jnp.asarray(v) for k, v in a.items()})
    from speechflow_torch.models.tts import TTSForwardInput

    return TTSForwardInput(**{k: t(v) for k, v in a.items()})


def models(seed: int = 1):
    from speechflow_tpu.models.aligner import GlowTTSAligner as J
    from speechflow_tpu.models.aligner import GlowTTSParams as JP

    jm = randomize(J(JP.create(PARAMS), rngs=nnx.Rngs(0)), seed=seed)
    tm = port(GlowTTSAligner(GlowTTSParams.create(PARAMS)), jm)
    no_dropout(jm, tm)
    return jm, tm


def test_inv1x1_init_equals_jax():
    from speechflow_tpu.models.aligner.flows import Inv1x1Conv as J

    ref = np.asarray(J(8, 4, rngs=nnx.Rngs(0)).weight[...])
    got = n(Inv1x1Conv(8, 4).weight)
    np.testing.assert_array_equal(got, ref)
    fresh = GlowTTSAligner(GlowTTSParams.create(PARAMS))
    for ic, cp in zip(fresh.flow.invconvs, fresh.flow.couplings):
        np.testing.assert_array_equal(n(ic.weight), ref)  # every flow: the same Q
        assert not cp.post.weight.any() and not cp.post.bias.any()  # identity couplings
    with pytest.raises(ValueError, match="groups"):
        Inv1x1Conv(6, 4)


@pytest.mark.parametrize("cond", [False, True])
def test_flows_forward_reverse(rng, cond):
    from speechflow_tpu.models.aligner.flows import FlowSpecDecoder as J

    cd = 5 if cond else None
    jm = randomize(J(6, n_flows=3, hidden=8, cond_dim=cd, rngs=nnx.Rngs(0)), seed=2)
    tm = port(FlowSpecDecoder(6, n_flows=3, hidden=8, cond_dim=cd), jm)
    mel = rng.normal(size=(2, 23, 6)).astype(np.float32)
    lens = np.asarray([23, 14], np.int32)
    c = rng.normal(size=(2, 5)).astype(np.float32) if cond else None
    z_ref, ld_ref = jm(jnp.asarray(mel), jnp.asarray(lens), None if c is None else jnp.asarray(c))
    z, ld = tm(t(mel), t(lens), None if c is None else t(c))
    close(z, z_ref)
    close(ld, ld_ref)
    back_ref, _ = jm(z_ref, jnp.asarray(lens), None if c is None else jnp.asarray(c),
                     reverse=True)
    back, none = tm(z, t(lens), None if c is None else t(c), reverse=True)
    assert none is None
    close(back, back_ref)
    mask = np.arange(22)[None, :, None] < (lens // 2 * 2)[:, None, None]
    assert np.abs((n(back) - mel[:, :22]) * mask).max() < 1e-4  # invertible on the valid frames

    # the log-determinant against the Jacobian's, on a tiny unmasked case
    x = torch.from_numpy(rng.normal(size=(1, 4, 6)).astype(np.float32))
    full = torch.tensor([4])
    cc = None if c is None else t(c[:1])
    jac = torch.autograd.functional.jacobian(
        lambda v: tm(v.reshape(1, 4, 6), full, cc)[0].reshape(-1), x.reshape(-1))
    np.testing.assert_allclose(float(tm(x, full, cc)[1][0]),
                               float(torch.linalg.slogdet(jac.double())[1]), atol=1e-3)


@pytest.mark.parametrize("training", [False, True])
def test_aligner_outputs(rng, training):
    """The deterministic call (``align``'s; the fused attention's path on the
    GPU) and the training call (dropout 0): every output, the path and the
    durations exactly."""
    from speechflow_torch.convert import flatten_nnx, nnx_from_module

    jm, tm = models()
    back = flatten_nnx(nnx_from_module(tm))  # the mapping both ways, leaf for leaf
    want = flatten_nnx(nnx.to_pure_dict(nnx.state(jm, nnx.Not(nnx.RngState))))
    assert set(back) == set(want) and all(np.array_equal(back[k], want[k]) for k in want)
    a = batch(rng)
    ref = jm(inputs(a, True), training=training)
    got = tm(inputs(a, False), training=training)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(n(got["path"]), np.asarray(ref["path"]))
    np.testing.assert_array_equal(n(got["durations"]), np.asarray(ref["durations"]))
    np.testing.assert_array_equal(n(got["mel_lengths"]), np.asarray(ref["mel_lengths"]))
    assert (n(got["durations"]).sum(1) == np.asarray([40, 30, 16])).all()
    for k in ("z", "logdet", "mu_t", "logstd_t", "log_dur_pred"):
        close(got[k], ref[k])
    d, path = tm.align(inputs(a, False))
    jd, jp = jm.align(inputs(a, True))
    np.testing.assert_array_equal(n(d), np.asarray(jd))
    np.testing.assert_array_equal(n(path), np.asarray(jp))


def test_aligner_criterion(rng):
    from speechflow_torch.models.tts.data_types import TTSTarget
    from speechflow_tpu.models.aligner import AlignerCriterion as JC
    from speechflow_tpu.models.tts.data_types import TTSTarget as JT

    jm, tm = models()
    a = batch(rng)
    ref = JC(duration_scale=0.5)(jm(inputs(a, True), training=True),
                                 JT(transcription_lengths=jnp.asarray(a["transcription_lengths"])),
                                 0)
    got = AlignerCriterion(duration_scale=0.5)(
        tm(inputs(a, False), training=True),
        TTSTarget(transcription_lengths=t(a["transcription_lengths"])), 0)
    assert set(got) == set(ref) == {"mle", "duration"}
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)


def test_generate(rng):
    jm, tm = models()
    a = batch(rng)
    a.pop("mel"), a.pop("mel_lengths")
    dur = np.where(np.arange(7)[None] < a["transcription_lengths"][:, None],
                   rng.integers(1, 4, (3, 7)), 0).astype(np.float32)
    key = jax.random.PRNGKey(3)
    for d in (dur, None):
        ref, ref_lens = jm.generate(inputs(a, True), None if d is None else jnp.asarray(d),
                                    key=key, t_out=24)
        noise = t(jax.random.normal(key, (3, 24, 8)))
        got, lens = tm.generate(inputs(a, False), None if d is None else t(d), t_out=24,
                                noise=noise)
        np.testing.assert_array_equal(n(lens), np.asarray(ref_lens))
        close(got, ref)


def test_training_step_matches_jax(rng):
    """One step of the generic trainers on the aligner (SGD at lr 1): the losses
    and the update."""
    from speechflow_torch.convert import flatten_nnx, nnx_from_module
    from speechflow_torch.models.tts.data_types import TTSTarget
    from speechflow_torch.training.optimizer import OptimizerConfig
    from speechflow_torch.training.trainer import Trainer, TrainerConfig
    from speechflow_tpu.models.aligner import AlignerCriterion as JC
    from speechflow_tpu.models.tts.data_types import TTSTarget as JT
    from speechflow_tpu.training import OptimizerConfig as JOpt
    from speechflow_tpu.training import Trainer as JTrainer
    from speechflow_tpu.training import TrainerConfig as JCfg

    jm, tm = models(seed=4)
    a = batch(rng)
    opt = dict(method="sgd", lr=1.0, lr_schedule="ConstLR", grad_clip=None, betas=(0.0, 0.999))

    def jbp(_):
        return inputs(a, True), JT(transcription_lengths=jnp.asarray(a["transcription_lengths"]))

    def tbp(_):
        return inputs(a, False), TTSTarget(transcription_lengths=t(a["transcription_lengths"]))

    jt = JTrainer(jm, JC(), jbp, JOpt.from_config(opt), JCfg(max_steps=5))
    tt = Trainer(tm, AlignerCriterion(), tbp, OptimizerConfig.from_config(opt),
                 TrainerConfig(max_steps=5))
    before = flatten_nnx(nnx_from_module(tm))
    jl, tl = jt.training_step(None), tt.training_step(None)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    got = flatten_nnx(nnx_from_module(tm))
    ref = flatten_nnx(nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
    scale = max(np.abs(ref[k] - before[k]).max() for k in ref)
    err = max(np.abs((got[k] - before[k]) - (ref[k] - before[k])).max() for k in ref)
    assert 0 < scale and err <= 1e-4 * scale, (err, scale)


def _raw_samples():
    """The SEGS raw grids through the port's and JAX's stage-1 parsers."""
    from speechflow_torch.data.parsers import TTSDSParser
    from speechflow_torch.io.flist import construct_file_list
    from speechflow_tpu.data.parsers import TTSDSParser as JP

    files = construct_file_list(SEGS, ext=".TextGrid")
    kw = dict(max_duration=12.0, min_duration=0.3, audio_strip=True, audio_strip_pad=0.25)
    ours = TTSDSParser(**kw).read_datasamples(files)
    jp = JP(**kw)
    theirs = [jp.to_datasample(md) for f in files
              for md in [jp.run_preprocessing(jp.reader(f)[0])] if md is not None]
    assert len(ours) == len(theirs) == len(files) > 10
    return ours, theirs


@pytest.mark.parametrize("level", ["words", "punctuation"])
def test_stage1_handlers_over_segs(level):
    """``phonemize`` (text-only samples: the phoneme tier dropped) and
    ``add_pauses_from_text`` (by word timestamps, and by ``word_lengths``) over
    every raw grid of SEGS, and ``PhonemeStatistics`` of a text-only corpus."""
    from speechflow_torch.data.processors.singletons import PhonemeStatistics
    from speechflow_torch.data.processors.text import phonemize
    from speechflow_torch.data.processors.tts import add_pauses_from_text
    from speechflow_tpu.data.processors.singletons import PhonemeStatistics as JPS
    from speechflow_tpu.data.processors.text import phonemize as jphonemize
    from speechflow_tpu.data.processors.tts import add_pauses_from_text as jpauses

    ours, theirs = _raw_samples()
    for a, b in zip(ours, theirs):
        assert a.phonemes == b.phonemes and a.text == b.text
        x, y = add_pauses_from_text(a.copy(), level), jpauses(copy.deepcopy(b), level)
        assert x.phonemes == y.phonemes and x.phoneme_timestamps is None
        a2, b2 = a.copy(), copy.deepcopy(b)
        a2.phonemes, b2.phonemes = [], []
        a2, b2 = phonemize(a2), jphonemize(b2)
        assert a2.phonemes == b2.phonemes and len(a2.phonemes) > 5
        np.testing.assert_array_equal(a2.word_lengths, b2.word_lengths)
        x, y = add_pauses_from_text(a2, level), jpauses(b2, level)
        assert x.phonemes == y.phonemes
    text_only = [s.copy() for s in ours]
    for s in text_only:
        s.phonemes = []
    jtext = [copy.deepcopy(s) for s in theirs]
    for s in jtext:
        s.phonemes = []
    ref = JPS()
    ref.counts = {}  # the JAX handler is a process-wide singleton: start it empty
    assert PhonemeStatistics().fit(text_only).counts == ref.fit(jtext).counts


def test_stage1_pipeline_matches_jax(monkeypatch):
    """``configs/aligner_data_stage1.yml`` (debug) over SEGS through both
    packages' pipelines: the same alphabet and a batch of the same tokens and mel."""
    from speechflow_torch.data.core.components import DataPipeline
    from speechflow_torch.scripts.train_aligner import configs
    from speechflow_tpu.data.core.components import DataPipeline as JDP
    from speechflow_tpu.io import Config

    monkeypatch.delenv("SFTPU_DUMP_CACHE", raising=False)
    _, data_cfg = configs("debug", data_root=SEGS)
    ours = DataPipeline.from_config(data_cfg)
    ref = JDP(Config(data_cfg)).init_components()
    assert ours.get_info()["alphabet"] == ref.get_info()["alphabet"]
    mine, theirs = ours.datasets["train"][:2], list(ref["train"].dataset)[:2]
    got = ours.datasample_to_batch([s.copy() for s in mine])
    want = ref["train"].datasample_to_batch([s.copy() for s in theirs]).collated_samples
    for name in ("transcription", "transcription_lengths", "mel", "mel_lengths"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def test_textgrid_writer_text(tmp_path):
    """The writer's text equals JAX's: a SEGS grid re-written, a grid with quotes
    and awkward numbers, and ``AudioSeg.save`` with a meta dict of numpy values."""
    from speechflow_torch.io.seg import AudioSeg, TextGrid, Tier
    from speechflow_tpu.io import AudioSeg as JSeg
    from speechflow_tpu.io import TextGrid as JGrid
    from speechflow_tpu.io import Tier as JTier

    src = SEGS / "EN" / "LJSpeech" / "000" / "0.TextGridStage3"
    assert TextGrid.load(src).dumps() == JGrid.load(src).dumps()
    ivs = [(0.0, 1e-7, ""), (1e-7, 0.1234565, 'say "hi"'), (0.1234565, 2.5, "x")]
    g, jg = TextGrid(), JGrid()
    g.add(Tier("phonemes", ivs)).add(Tier("text", ivs[:2])).add(Tier("phonemes", ivs[1:]))
    jg.add(JTier("phonemes", ivs)).add(JTier("text", ivs[:2])).add(JTier("phonemes", ivs[1:]))
    assert g.dumps() == jg.dumps() and g.tier_names == ["text", "phonemes"]
    s, js = AudioSeg.load(src), JSeg.load(src)
    for seg in (s, js):
        seg.meta["speech_begin"] = np.float32(0.25)
        seg.meta["ids"] = np.arange(3)
    s.save(tmp_path / "a.TextGridStage1")
    js.save(tmp_path / "b.TextGridStage1")
    assert (tmp_path / "a.TextGridStage1").read_text() == \
        (tmp_path / "b.TextGridStage1").read_text()
    assert AudioSeg.load(tmp_path / "a.TextGridStage1").meta["ids"] == [0, 1, 2]


@pytest.fixture(scope="module")
def jax_stage1_checkpoint(tmp_path_factory):
    """A checkpoint of the JAX ``train_aligner`` (stage 1 debug recipe, 2 steps)."""
    from speechflow_tpu.io import Config
    from speechflow_tpu.scripts import train_aligner
    from speechflow_tpu.training import ExperimentSaver

    out = tmp_path_factory.mktemp("jax_aligner")
    cfg = Config.create_from_file(REPO / "configs" / "aligner_model.yml", value_select=["debug"])
    cfg.set_path("experiment.base_dir", str(out))
    cfg.set_path("trainer.max_steps", 2)
    cfg.set_path("trainer.ckpt_every", 2)
    mpath = out / "aligner_model.yml"
    cfg.to_file(mpath)
    exp = train_aligner.main(["-c", str(mpath), "-cd",
                              str(REPO / "configs" / "aligner_data_stage1.yml"), "-vs", "debug",
                              "--data_root", str(SEGS)])
    return ExperimentSaver.get_last_checkpoint(exp)


def test_port_aligner_over_jax_checkpoint(jax_stage1_checkpoint, tmp_path):
    """The port's ``Aligner`` (CPU) and the JAX one over the same JAX checkpoint
    and the same 10 raw grids: the same ``.TextGridStage1`` files, phoneme
    intervals and meta."""
    from speechflow_torch.annotator.align import Aligner, AlignStage
    from speechflow_torch.io.seg import AudioSeg
    from speechflow_tpu.annotator.align import Aligner as JAligner
    from speechflow_tpu.annotator.align import AlignStage as JStage

    src = SEGS / "EN" / "LJSpeech" / "000"
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        for f in src.glob("*.TextGrid"):
            shutil.copy(f, tmp_path / side / f.name)
            shutil.copy(f.with_suffix(".wav"), tmp_path / side / f.with_suffix(".wav").name)
    got = Aligner(jax_stage1_checkpoint, batch_size=4, device="cpu").run(
        tmp_path / "port", AlignStage.stage1)
    ref = JAligner(jax_stage1_checkpoint, batch_size=4).run(tmp_path / "jax", JStage.stage1)
    assert sorted(p.name for p in got) == sorted(p.name for p in ref)
    assert len(got) == 10
    for p in got:
        a, b = AudioSeg.load(p), AudioSeg.load(tmp_path / "jax" / p.name)
        assert [iv[2] for iv in a.phonemes()] == [iv[2] for iv in b.phonemes()], p.name
        np.testing.assert_allclose(np.asarray([iv[:2] for iv in a.phonemes()]),
                                   np.asarray([iv[:2] for iv in b.phonemes()]), atol=1e-6)
        assert a.meta == b.meta and len(a.phonemes()) > 20
