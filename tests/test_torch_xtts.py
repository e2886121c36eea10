"""The port's XTTS serving path against the JAX package (f32, CPU): RoPE at
given positions, the causal and retention blocks (parallel, prefill, decode
step), the GPT's teacher-forced and KV-cached logits, sampling (argmax, and
JAX's own Gumbel draws injected), the prompt encoder, the RVQ codec at the
recipe's strides with JAX's clamped ``lookup``, ``XTTSModel`` end to end, the
fresh weights, and ``XTTSEvaluationInterface`` from checkpoints.

Widths are the recipe's debug ones (``configs/xtts_model.yml``: dim 48,
2 heads, codec channels 8 at strides 4·8·8); weights are seeded
(``tests/torch_parity.py``) and copied with ``speechflow_torch.convert``.
Tolerances: blocks and RoPE 2e-5; GPT logits 1e-4 of their scale; codec and
prompt encoder 1e-5; waveforms 1e-4 of their scale; tokens identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch import serving
from speechflow_torch.convert import flatten_nnx, nnx_from_module
from speechflow_torch.interface.xtts_interface import XTTSEvaluationInterface
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.models.codec import CodecParams, NeuralCodec
from speechflow_torch.models.layers import Conv1d, ConvTranspose1d
from speechflow_torch.models.tts import XTTSModel, XTTSParams
from speechflow_torch.models.tts.ar_decoders import CausalBlock, GPTDecoder, RetentionBlock
from speechflow_torch.models.tts.common import rope_rotate
from speechflow_torch.scripts.train_tts import configs
from speechflow_torch.training.saver import ExperimentSaver
from tests.torch_parity import n, port, randomize, t

torch.set_num_threads(1)
XTTS_DEBUG = configs("debug", "configs/xtts_model.yml")[0]["model"]
BLOCK_TOL = 2e-5
LOGIT_TOL = 1e-4  # of the logits' largest magnitude
CODEC_TOL = 1e-5
WAVE_TOL = 1e-4  # of the waveform's largest magnitude
N_MELS = serving.TTS_DATA_CONFIG["preproc"]["pipe_cfg"]["linear_to_mel"]["n_mels"]
BLOCKS = ("attention", "retention")


def _cfg(block_type: str = "attention", **kw) -> dict:
    """The debug recipe with a prompt of the data config's mel bins and 3 speakers."""
    c = dict(XTTS_DEBUG, n_layers=2, n_symbols=40, n_speakers=3,
             prompt_dim=N_MELS, block_type=block_type)
    c.update(kw)
    return c


def _pair(cfg: dict, seed: int = 0):
    from speechflow_tpu.models.tts.xtts import XTTSModel as JX
    from speechflow_tpu.models.tts.xtts import XTTSParams as JP

    jm = randomize(JX(JP.create(cfg), rngs=nnx.Rngs(0)), seed)
    return jm, port(XTTSModel(XTTSParams.create(cfg)), jm)


@pytest.fixture(scope="module", params=BLOCKS)
def models(request):
    return _pair(_cfg(request.param))


def _close(got, ref, tol, scale: bool = False, what: str = ""):
    got, ref = n(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    lim = tol * (np.abs(ref).max() if scale else 1.0)
    err = np.abs(got - ref).max()
    assert err <= lim, f"{what}: {err} > {lim}"


def _gumbel_draws(key, n_tokens: int, shape) -> np.ndarray:
    """The noise JAX's ``generate`` adds to each token's logits: the key is split
    once before token 0 and once a step, and ``categorical`` adds
    ``gumbel(sub, logits.shape)``."""
    out = []
    for _ in range(n_tokens):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))
    return np.stack(out)


def _rng(seed=0):
    return np.random.default_rng(seed)


# -- layers -----------------------------------------------------------------------


def test_rope_rotate_at_given_positions():
    from speechflow_tpu.models.tts.common import rope_rotate as jrope

    x = _rng().normal(size=(2, 3, 5, 11)).astype(np.float32)  # odd D keeps its last column
    for pos in (None, np.array([7, 0, 3, 120, 9], np.int32)):
        ref = jrope(jnp.asarray(x), positions=None if pos is None else jnp.asarray(pos))
        got = rope_rotate(t(x), positions=None if pos is None else t(pos))
        _close(got, ref, BLOCK_TOL, what=f"positions {pos}")
    one = rope_rotate(t(x[:, :, 3:4]), positions=torch.tensor([3]))
    _close(one, n(rope_rotate(t(x[:, :, :4])))[:, :, 3:4], BLOCK_TOL, what="row 3 alone")


@pytest.mark.parametrize("t_len", [64, 70, 1])
def test_strided_conv_layers_match_flax(t_len):
    """``Conv1d`` at stride s, kernel 2s (XLA SAME: ceil(T/s) outputs, the odd pad
    high) and ``ConvTranspose1d`` at the codec's strides (T·s outputs)."""
    for s in (4, 8):
        jc = randomize(nnx.Conv(3, 5, (2 * s,), strides=(s,), padding="SAME",
                                rngs=nnx.Rngs(0)))
        x = _rng(s).normal(size=(2, t_len, 3)).astype(np.float32)
        _close(port(Conv1d(3, 5, 2 * s, stride=s), jc)(t(x)), jc(jnp.asarray(x)), CODEC_TOL,
               what=f"conv s{s}")
        jt = randomize(nnx.ConvTranspose(3, 5, (2 * s,), strides=(s,), padding="SAME",
                                         rngs=nnx.Rngs(1)))
        _close(port(ConvTranspose1d(3, 5, 2 * s, s), jt)(t(x)), jt(jnp.asarray(x)), CODEC_TOL,
               what=f"transpose s{s}")


@pytest.mark.parametrize("block", BLOCKS)
def test_blocks_match_jax(block):
    """``__call__`` under a causal mask with padded keys, ``prefill`` with and
    without ``valid``, then decode steps from the prefilled cache."""
    from speechflow_tpu.models.tts import ar_decoders as J

    d, h, b, t_len, l_max = 48, 2, 2, 9, 14
    jblk = randomize((J.RetentionBlock if block == "retention" else J.CausalBlock)(
        d, h, nnx.Rngs(0)))
    tblk = port((RetentionBlock if block == "retention" else CausalBlock)(d, h), jblk)
    rng = _rng(1)
    x = rng.normal(size=(b, t_len, d)).astype(np.float32)
    valid = np.ones((b, l_max), bool)
    valid[1, 3:5] = False
    mask = np.tril(np.ones((t_len, t_len), bool))[None, None] & valid[:, None, None, :t_len]
    _close(tblk(t(x), t(mask)), jblk(jnp.asarray(x), jnp.asarray(mask)), BLOCK_TOL,
           what="call")
    for v in (None, valid):
        jv, tv = (None, None) if v is None else (jnp.asarray(v), t(v))
        jy, jc = jblk.prefill(jnp.asarray(x), jblk.init_cache(b, l_max), valid=jv)
        ty, tc = tblk.prefill(t(x), tblk.init_cache(b, l_max), valid=tv)
        _close(ty, jy, BLOCK_TOL, what="prefill")
        for pos in range(t_len, t_len + 3):
            xt = rng.normal(size=(b, 1, d)).astype(np.float32)
            jy, jc = jblk.decode_step(jnp.asarray(xt), jc, pos, valid=jv)
            ty, tc = tblk.decode_step(t(xt), tc, pos, valid=tv)
            _close(ty, jy, BLOCK_TOL, what=f"decode {pos}")
            for a, r in zip(tc if block == "attention" else [tc],
                            jc if block == "attention" else [jc]):
                _close(a, r, BLOCK_TOL, what=f"cache {pos}")


# -- the GPT ----------------------------------------------------------------------


def _gpt_inputs(jm, tm, ragged: bool, seed: int = 2):
    """Text ids, speaker conditions and an encoded prompt (ragged or None) for both."""
    rng = _rng(seed)
    text = rng.integers(1, 40, (2, 16)).astype(np.int32)
    sid = np.array([2, 0], np.int32)
    jcond, tcond = jm.speaker_emb(jnp.asarray(sid)), tm._cond(t(sid))
    if not ragged:
        return text, (jcond, None, None), (tcond, None, None)
    mel = rng.normal(size=(2, 40, N_MELS)).astype(np.float32)
    lens = np.array([40, 17], np.int32)
    jp = jm._encode_prompt(jnp.asarray(mel), jnp.asarray(lens))
    tp_ = tm._encode_prompt(t(mel), t(lens))
    return text, (jcond, *jp), (tcond, *tp_)


@pytest.mark.parametrize("ragged", [False, True])
def test_gpt_teacher_forced_logits_match_jax(models, ragged):
    jm, tm = models
    text, (jc, jpe, jpl), (tc, tpe, tpl) = _gpt_inputs(jm, tm, ragged)
    audio = _rng(3).integers(0, 64, (2, 20)).astype(np.int32)
    ref = jm.gpt(jnp.asarray(text), jnp.asarray(audio), jc, prompt_emb=jpe, prompt_lengths=jpl)
    with torch.no_grad():
        got = tm.gpt(t(text), t(audio).long(), tc, prompt_emb=tpe, prompt_lengths=tpl)
    _close(got, ref, LOGIT_TOL, scale=True, what="teacher-forced logits")


def _cached_logits(gpt, xp, text, audio, cond, pe, pl):
    """The logits of the KV-cached path over given audio tokens: the prefill's
    last row, then each decode step's (``generate``'s steps with the tokens fixed)."""
    b, n_tok = audio.shape
    cat = xp.concatenate if xp is jnp else torch.cat
    cond_emb = None if cond is None else gpt.cond_proj(cond)[:, None, :]
    prefix, pvalid = gpt._prefix(text, pe, pl)
    bos = gpt.audio_emb(xp.full((b, 1), gpt.bos, dtype=xp.int32 if xp is jnp else torch.long))
    x = cat([prefix, bos], 1) + cond_emb
    t_prefix = x.shape[1]
    valid = None
    if pl is not None:
        valid = cat([pvalid, xp.ones((b, 1 + n_tok), dtype=xp.bool_ if xp is jnp
                                     else torch.bool)], 1)
    caches = []
    for blk in gpt.blocks:
        x, c = blk.prefill(x, blk.init_cache(b, t_prefix + n_tok), valid=valid)
        caches.append(c)
    out = [gpt.head(gpt.norm(x[:, -1]))]
    for i in range(1, n_tok):
        x = gpt.audio_emb(audio[:, i - 1:i]) + cond_emb
        for j, blk in enumerate(gpt.blocks):
            x, caches[j] = blk.decode_step(x, caches[j], t_prefix - 1 + i, valid=valid)
        out.append(gpt.head(gpt.norm(x[:, 0])))
    return out


@pytest.mark.parametrize("ragged", [False, True])
def test_kv_cached_logits_match_jax(models, ragged):
    """Prefill and decode-step logits over fixed tokens, against JAX's and against
    the port's own teacher-forced logits."""
    jm, tm = models
    text, (jc, jpe, jpl), (tc, tpe, tpl) = _gpt_inputs(jm, tm, ragged)
    audio = _rng(4).integers(0, 64, (2, 12)).astype(np.int32)
    ref = _cached_logits(jm.gpt, jnp, jnp.asarray(text), jnp.asarray(audio), jc, jpe, jpl)
    with torch.no_grad():
        got = _cached_logits(tm.gpt, torch, t(text), t(audio).long(), tc, tpe, tpl)
        forced = tm.gpt(t(text), t(audio).long(), tc, prompt_emb=tpe, prompt_lengths=tpl)
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, LOGIT_TOL, scale=True, what=f"step {i}")
        _close(g, forced[:, i], LOGIT_TOL, scale=True, what=f"step {i} vs teacher-forced")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("ragged", [False, True])
def test_generate_matches_jax(models, temperature, ragged):
    """32 tokens, identical: argmax, and under JAX's own Gumbel draws."""
    jm, tm = models
    text, (jc, jpe, jpl), (tc, tpe, tpl) = _gpt_inputs(jm, tm, ragged)
    key = jax.random.PRNGKey(7)
    ref = jm.gpt.generate(jnp.asarray(text), max_tokens=32, temperature=temperature, key=key,
                          cond=jc, prompt_emb=jpe, prompt_lengths=jpl)
    draws = _gumbel_draws(key, 32, (2, jm.gpt.n_audio_tokens))
    got = tm.gpt.generate(t(text), max_tokens=32, temperature=temperature, cond=tc,
                          prompt_emb=tpe, prompt_lengths=tpl,
                          gumbel=t(draws) if temperature else None)
    np.testing.assert_array_equal(n(got).astype(np.int64), np.asarray(ref))
    assert len(np.unique(np.asarray(ref))) > 1


@pytest.mark.parametrize("block", BLOCKS)
def test_generate_matches_generate_naive(block):
    """The KV-cached decode against rerunning the whole trunk a token, with a
    ragged prompt: at temperature 0, and under one torch generator's draws."""
    _, tm = _pair(_cfg(block), seed=5)
    text, _, (tc, tpe, tpl) = _gpt_inputs(*_pair(_cfg(block), seed=5), True)
    for temperature in (0.0, 1.0):
        runs = [fn(t(text), max_tokens=24, temperature=temperature,
                   generator=torch.Generator().manual_seed(3), cond=tc, prompt_emb=tpe,
                   prompt_lengths=tpl)
                for fn in (tm.gpt.generate, tm.gpt.generate_naive)]
        assert torch.equal(*runs)


def test_sample_is_jax_categorical():
    """``_sample`` with given Gumbel draws is ``jax.random.categorical``."""
    key = jax.random.PRNGKey(1)
    logits = _rng(6).normal(size=(64, 30)).astype(np.float32) * 3
    ref = jax.random.categorical(key, jnp.asarray(logits) / 0.7, axis=-1)
    g = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = GPTDecoder._sample(t(logits), 0.7, gumbel=t(g))
    np.testing.assert_array_equal(n(got).astype(np.int64), np.asarray(ref))
    np.testing.assert_array_equal(n(GPTDecoder._sample(t(logits), 0.0)), logits.argmax(-1))


# -- prompt encoder and codec -------------------------------------------------------


@pytest.mark.parametrize("cap", [0, 64])
def test_prompt_encoder_matches_jax(cap):
    """Ragged lengths (ceil(T/4) frames each), a prompt longer than
    ``prompt_max_frames`` cut to it; valid rows."""
    jm, tm = _pair(_cfg(prompt_max_frames=cap), seed=1)
    mel = _rng(7).normal(size=(3, 90, N_MELS)).astype(np.float32)
    lens = np.array([90, 61, 5], np.int32)
    jemb, jlen = jm._encode_prompt(jnp.asarray(mel), jnp.asarray(lens))
    temb, tlen = tm._encode_prompt(t(mel), t(lens))
    np.testing.assert_array_equal(n(tlen), np.asarray(jlen))
    assert temb.shape[1] == -(-(cap or 90) // 4)
    for row, m in enumerate(np.asarray(jlen)):
        _close(temb[row, :m], np.asarray(jemb)[row, :m], CODEC_TOL, what=f"row {row}")


def test_codec_matches_jax():
    """encode (codes identical), decode of all streams and of one, and the
    training forward (reconstruction and VQ loss) at strides 4·8·8."""
    from speechflow_tpu.models.codec import CodecParams as JCP
    from speechflow_tpu.models.codec import NeuralCodec as JNC

    cfg = XTTS_DEBUG["codec"]
    jc = randomize(JNC(JCP.create(cfg), rngs=nnx.Rngs(0)))
    tc = port(NeuralCodec(CodecParams.create(cfg)), jc)
    wav = (0.5 * _rng(8).normal(size=(2, 2000))).astype(np.float32)
    codes = jc.encode(jnp.asarray(wav))
    np.testing.assert_array_equal(n(tc.encode(t(wav))).astype(np.int64), np.asarray(codes))
    assert codes.shape == (2, 8, 2)
    with torch.no_grad():
        for c in (codes, codes[..., :1]):
            _close(tc.decode(t(c).long()), jc.decode(c), CODEC_TOL, what=f"decode {c.shape}")
        rec, tcodes, loss = tc(t(wav))
    jrec, _, jloss = jc(jnp.asarray(wav))
    _close(rec, jrec, CODEC_TOL, what="reconstruction")
    _close(loss, jloss, CODEC_TOL, scale=True, what="vq loss")


def test_lookup_clamps_like_jax():
    """XTTS decodes one stream; every RVQ stage then reads that stream's code, in
    JAX (its static index past the end is clamped) and in the port (explicitly)."""
    from speechflow_tpu.models.codec import CodecParams as JCP
    from speechflow_tpu.models.codec import NeuralCodec as JNC

    cfg = dict(XTTS_DEBUG["codec"], n_quantizers=4)
    jc = randomize(JNC(JCP.create(cfg), rngs=nnx.Rngs(0)))
    tc = port(NeuralCodec(CodecParams.create(cfg)), jc)
    codes = _rng(9).integers(0, 64, (2, 5, 1))
    ref = np.asarray(jc.rvq.lookup(jnp.asarray(codes)))
    books = [np.asarray(s.codebook[...]) for s in jc.rvq.stages]
    np.testing.assert_allclose(ref, sum(b[codes[..., 0]] for b in books), atol=1e-6)
    _close(tc.rvq.lookup(t(codes)), ref, CODEC_TOL, what="one stream")
    two = _rng(10).integers(0, 64, (2, 5, 2))
    _close(tc.rvq.lookup(t(two)), jc.rvq.lookup(jnp.asarray(two)), CODEC_TOL,
           what="two streams")


# -- the model ----------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_synthesize_matches_jax(models, temperature):
    jm, tm = models
    rng = _rng(11)
    text = rng.integers(1, 40, (2, 16)).astype(np.int32)
    sid = np.array([1, 2], np.int32)
    mel = rng.normal(size=(2, 30, N_MELS)).astype(np.float32)
    lens = np.array([30, 21], np.int32)
    key = jax.random.PRNGKey(5)
    ref = jm.synthesize(jnp.asarray(text), jnp.asarray(sid), max_tokens=24,
                        temperature=temperature, key=key, prompt_mel=jnp.asarray(mel),
                        prompt_mel_lengths=jnp.asarray(lens))
    draws = _gumbel_draws(key, 24, (2, jm.gpt.n_audio_tokens))
    got = tm.synthesize(t(text), t(sid), max_tokens=24, temperature=temperature,
                        prompt_mel=t(mel), prompt_mel_lengths=t(lens), gumbel=t(draws))
    assert got.shape == (2, 24 * 256)
    _close(got, ref, WAVE_TOL, scale=True, what="waveform")


def test_teacher_forced_call_matches_jax(models):
    """``gpt_ce`` of the codes the codec encodes from the waveform, with ragged
    waveform and prompt lengths."""
    jm, tm = models
    rng = _rng(12)
    inputs = {"transcription": rng.integers(1, 40, (2, 16)).astype(np.int32),
              "waveform": (0.3 * rng.normal(size=(2, 4096))).astype(np.float32),
              "waveform_lengths": np.array([4096, 2500], np.int32),
              "speaker_id": np.array([0, 2], np.int32),
              "prompt_mel": rng.normal(size=(2, 24, N_MELS)).astype(np.float32),
              "prompt_mel_lengths": np.array([24, 9], np.int32)}
    ref = jm({k: jnp.asarray(v) for k, v in inputs.items()})["gpt_ce"]
    got = tm({k: t(v) for k, v in inputs.items()})["gpt_ce"]
    _close(got, ref, LOGIT_TOL, scale=True, what="gpt_ce")
    got.backward()
    assert tm.gpt.head.weight.grad is not None and tm.codec.enc_pre.weight.grad is None


def test_fresh_weights_follow_flax_initialisers():
    """A model built from its params starts from the JAX model's distribution:
    tensors constant in the JAX model (biases, norm scales) are equal; every other
    tensor's standard deviation is within 6/sqrt(size) of the JAX one's and its mean
    within six standard errors of 0 (``boa_tok`` N(0, 0.02), codebooks N(0, 1))."""
    from speechflow_tpu.models.tts.xtts import XTTSModel as JX
    from speechflow_tpu.models.tts.xtts import XTTSParams as JP

    cfg = _cfg(block_type="retention", dim=96)
    ref = flatten_nnx(nnx.to_pure_dict(nnx.state(JX(JP.create(cfg), rngs=nnx.Rngs(0)),
                                                 nnx.Param)))
    torch.manual_seed(0)
    got = flatten_nnx(nnx_from_module(XTTSModel(XTTSParams.create(cfg))))
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
    assert drawn > len(ref) // 3 and "gpt.boa_tok" in got


# -- the interface ------------------------------------------------------------------

SPEAKERS = {"amy": 0, "bob": 1, "cyd": 2}
TEXT = "Hello world, a zebra dozed."


def _payload(cfg: dict) -> dict:
    from speechflow_torch.data.processors.text import Alphabet, TextParserHook

    symbols = sorted(set(TextParserHook()(TEXT + " abcdefghijklmnopqrstuvwxyz")))
    return {"model_params": dict(cfg), "pipeline_info": {
        "config": serving.TTS_DATA_CONFIG, "subsets": ["train", "test"],
        "alphabet": Alphabet(symbols).to_dict(),
        "singletons": {"SpeakerIDSetter": {"speaker2id": SPEAKERS, "lang2id": {"EN": 0}}}}}


@pytest.fixture(scope="module")
def xtts_checkpoints(tmp_path_factory):
    """(JAX checkpoint, port checkpoint) of one model: the JAX saver's, and the
    port saver's of the same weights."""
    from speechflow_tpu.training import ExperimentSaver as JS

    cfg = _cfg(prompt_max_frames=64)
    jm, tm = _pair(cfg, seed=3)
    payload = _payload(cfg)
    js = JS(tmp_path_factory.mktemp("jax"), expr_suffix="xtts")
    js.to_save.update(payload)
    js.save(1, nnx.to_pure_dict(nnx.state(jm, nnx.Not(nnx.RngState))))
    ps = ExperimentSaver(tmp_path_factory.mktemp("port"), expr_suffix="xtts")
    ps.to_save.update(payload)
    ps.save(1, nnx_from_module(tm))
    return JS.get_last_checkpoint(js.expr_path), ExperimentSaver.get_last_checkpoint(ps.expr_path)


@pytest.fixture(scope="module")
def xtts_interfaces(xtts_checkpoints):
    from speechflow_tpu.interface import XTTSEvaluationInterface as J

    jax_ckpt, port_ckpt = xtts_checkpoints
    return XTTSEvaluationInterface(port_ckpt, device="cpu"), J(jax_ckpt)


def _ref_audio(sr: int = 24000, seconds: float = 1.3) -> np.ndarray:
    tt = np.arange(int(sr * seconds)) / sr
    return (0.4 * np.sin(2 * np.pi * 180 * tt * (1 + 0.2 * tt))
            + 0.02 * _rng(13).normal(size=tt.size)).astype(np.float32)


def test_interface_frontend_matches_jax(xtts_interfaces, tmp_path):
    from speechflow_tpu.io import AudioChunk as JChunk

    ours, ref = xtts_interfaces
    assert ours.get_speakers() == ref.get_speakers() == sorted(SPEAKERS)
    assert ours.sample_rate == ref.sample_rate == 24000
    np.testing.assert_array_equal(ours.prepare_text(TEXT), ref.prepare_text(TEXT))
    wav = _ref_audio()
    mel = ours.prompt_mel_from_audio(AudioChunk(data=wav, sr=24000))
    assert mel.shape == (wav.size // 256 + 1, N_MELS)
    np.testing.assert_allclose(mel, ref.prompt_mel_from_audio(JChunk(data=wav, sr=24000)),
                               atol=CODEC_TOL)
    # a file at another rate is resampled to the pipeline's first
    from scipy.io import wavfile

    wavfile.write(tmp_path / "ref.wav", 12000, _ref_audio(12000))
    chunk = AudioChunk(file_path=tmp_path / "ref.wav").load(sr=24000)
    np.testing.assert_allclose(ours.prompt_mel_from_audio(tmp_path / "ref.wav"),
                               ours.prompt_mel_from_audio(chunk), atol=1e-6)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_interface_synthesize_matches_jax(xtts_interfaces, temperature):
    """Text ids padded to a multiple of 16 (the padding attended), a speaker and a
    reference prompt longer than ``prompt_max_frames``; JAX's key of ``seed`` gives
    the draws."""
    ours, ref = xtts_interfaces
    wav = _ref_audio()
    seed = 4
    draws = _gumbel_draws(jax.random.PRNGKey(seed), 20, (1, ours.model.gpt.n_audio_tokens))
    kw = dict(speaker="bob", max_tokens=20, temperature=temperature, seed=seed)
    got = ours.synthesize(TEXT, ref_audio=AudioChunk(data=wav, sr=24000), gumbel=t(draws), **kw)
    from speechflow_tpu.io import AudioChunk as JChunk

    want = ref.synthesize(TEXT, ref_audio=JChunk(data=wav, sr=24000), **kw)
    assert got.sr == want.sr == 24000 and got.data.shape == (20 * 256,)
    _close(got.data, want.data, WAVE_TOL, scale=True, what="waveform")


def test_interface_seed_repeats_its_draws(xtts_interfaces):
    """A seed repeats its draws; another seed draws others."""
    ours, _ = xtts_interfaces
    kw = dict(max_tokens=12, temperature=1.0)
    wa = ours.synthesize(TEXT, seed=1, **kw).data
    np.testing.assert_array_equal(wa, ours.synthesize(TEXT, seed=1, **kw).data)
    assert not np.allclose(wa, ours.synthesize(TEXT, seed=2, **kw).data)
