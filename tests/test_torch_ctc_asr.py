"""The port's CTC recognizer against the JAX package (CPU, f32): logits and
output lengths with JAX's weights converted, ``recognize`` from a waveform,
``CTCLoss`` (``optax.ctc_loss`` semantics) and its gradient with padded
targets and frames (``CTC_TOL``), ``greedy_ctc_decode``, ``save_module``
pickles across the packages, and ``CTCPhonemeASR``'s windowed transcript."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.annotator.asr import CTCPhonemeASR, FileASR
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.models.asr import CTCRecognizer, CTCRecognizerParams, greedy_ctc_decode
from speechflow_torch.training.losses import CTCLoss
from speechflow_torch.utils.state_io import load_module, save_module
from tests.torch_parity import n, port, randomize, t

torch.set_num_threads(1)
CTC_TOL = 1e-5
SMALL = dict(n_symbols=7, n_mels=20, dim=24, n_conv=2, time_stride=2)


def _jax_ctc(seed: int = 0):
    from speechflow_tpu.models.asr import CTCRecognizer as J
    from speechflow_tpu.models.asr import CTCRecognizerParams as JP

    params = JP.create(SMALL)
    return randomize(J(params, rngs=nnx.Rngs(0)), seed), params


def _speech(seconds: float, seed: int = 0) -> np.ndarray:
    """60 ms segments of noise, tones and near-silence: frames whose labels change."""
    rng = np.random.default_rng(seed)
    tt = np.arange(1440) / 24000
    segs = []
    for _ in range(int(24000 * seconds) // 1440 + 1):
        kind = rng.integers(0, 3)
        if kind == 0:
            segs.append(rng.uniform(0.05, 0.5) * rng.normal(size=tt.size))
        elif kind == 1:
            segs.append(0.5 * np.sin(2 * np.pi * rng.uniform(100, 3000) * tt))
        else:
            segs.append(0.001 * rng.normal(size=tt.size))
    return np.concatenate(segs)[:int(24000 * seconds)].astype(np.float32)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_ctc_logits_match_jax(with_lengths):
    jm, _ = _jax_ctc()
    ours = port(CTCRecognizer(CTCRecognizerParams.create(SMALL)), jm)
    mel = np.random.default_rng(1).normal(size=(3, 33, 20)).astype(np.float32)
    lens = np.asarray([33, 20, 5], np.int32) if with_lengths else None
    ref, ref_lens = jm(jnp.asarray(mel), None if lens is None else jnp.asarray(lens))
    got, got_lens = ours(t(mel), None if lens is None else t(lens))
    assert tuple(got.shape) == (3, 17, 7)
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=CTC_TOL, rtol=0)
    np.testing.assert_array_equal(n(got_lens), np.asarray(ref_lens))


def test_recognize_matches_jax():
    jm, _ = _jax_ctc()
    ours = port(CTCRecognizer(CTCRecognizerParams.create(SMALL)), jm)
    wav = _speech(0.4)[None]
    ref = np.asarray(jm.recognize(jnp.asarray(wav)))
    got = n(ours.recognize(t(wav)))
    np.testing.assert_allclose(got, ref, atol=CTC_TOL * max(1.0, np.abs(ref).max()), rtol=0)


@pytest.mark.parametrize("lengths", ["none", "given"])
def test_ctc_loss_and_gradient_match_jax(lengths):
    from speechflow_tpu.training.losses import CTCLoss as JCTC

    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 16, 6)).astype(np.float32) * 2
    target = np.asarray([[1, 2, 2, 3], [4, 1, 0, 0], [5, 0, 0, 0]], np.int32)  # padded
    kw, tkw = {}, {}
    if lengths == "given":
        kw = dict(lengths=jnp.asarray([16, 11, 7]), target_lengths=jnp.asarray([4, 2, 1]))
        tkw = {k: t(np.asarray(v)) for k, v in kw.items()}
    jloss = JCTC(blank_id=0)

    ref, ref_grad = jax.value_and_grad(
        lambda x: jloss(x, jnp.asarray(target), **kw))(jnp.asarray(logits))
    x = t(logits).requires_grad_()
    loss = CTCLoss(blank_id=0)(x, t(target), **tkw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=CTC_TOL)
    scale = float(np.abs(np.asarray(ref_grad)).max())
    assert float(np.abs(n(x.grad) - np.asarray(ref_grad)).max()) <= CTC_TOL * scale


def test_greedy_decode_matches_jax():
    from speechflow_tpu.models.asr import greedy_ctc_decode as jdec

    rng = np.random.default_rng(3)
    for trial in range(5):
        logits = rng.normal(size=(30, 5)).astype(np.float32)
        logits[:, 0] += trial * 0.4  # from few blanks to many
        ids, spans = greedy_ctc_decode(t(logits), hop_s=0.02)
        rids, rspans = jdec(logits, hop_s=0.02)
        np.testing.assert_array_equal(ids, rids)
        assert spans == rspans
    ids, spans = greedy_ctc_decode(np.eye(4, dtype=np.float32)[[0, 1, 1, 0, 2, 2, 2, 0]])
    np.testing.assert_array_equal(ids, [1, 2])
    assert spans == [(1, 3), (4, 7)]


def test_ctc_checkpoints_cross_packages(tmp_path):
    from speechflow_tpu.models.asr import CTCRecognizer as J
    from speechflow_tpu.models.asr import CTCRecognizerParams as JP
    from speechflow_tpu.utils.state_io import load_module as jax_load
    from speechflow_tpu.utils.state_io import save_module as jax_save

    jm, jp = _jax_ctc()
    ours, params = load_module(CTCRecognizer, CTCRecognizerParams,
                               jax_save(jm, jp, tmp_path / "j.pkl"), device="cpu")
    mel = np.random.default_rng(4).normal(size=(2, 12, 20)).astype(np.float32)
    np.testing.assert_allclose(n(ours(t(mel))[0]), np.asarray(jm(jnp.asarray(mel))[0]),
                               atol=CTC_TOL, rtol=0)
    back, _ = jax_load(J, JP, save_module(ours, params, tmp_path / "p.pkl"))
    np.testing.assert_array_equal(np.asarray(back(jnp.asarray(mel))[0]),
                                  np.asarray(jm(jnp.asarray(mel))[0]))


@pytest.mark.parametrize("seconds", [0.7, 2.3])
def test_ctc_phoneme_asr_transcript_matches_jax(seconds, tmp_path):
    """Within one window, and across window boundaries (1.0 s windows with
    0.2 s overlaps): the same tokens with the same timestamps."""
    from speechflow_tpu.annotator.asr import CTCPhonemeASR as JASR
    from speechflow_tpu.io import AudioChunk as JChunk
    from speechflow_tpu.utils.state_io import save_module as jax_save

    jm, jp = _jax_ctc()
    path = jax_save(jm, jp, tmp_path / "ctc.pkl")
    symbols = {i: s for i, s in enumerate(["_", "AA", "B", "K", "IY", "S", "T"])}
    wav = _speech(seconds, seed=5)
    ref_asr, asr = JASR(path, symbols), CTCPhonemeASR(path, symbols, device="cpu")
    for a in (ref_asr, asr):
        a.chunk_s, a.overlap_s = 1.0, 0.2
    ref = ref_asr.transcribe(JChunk(data=wav, sr=24000))
    got = asr.transcribe(AudioChunk(data=wav, sr=24000))
    assert got["text"] == ref["text"] and len(got["timestamps"]) > 3
    for (tok, b, e), (rtok, rb, re) in zip(got["timestamps"], ref["timestamps"]):
        assert tok == rtok and abs(b - rb) < 1e-9 and abs(e - re) < 1e-9
    if seconds > 1.0:  # JAX keeps the tokens of the last window's zero padding; so does the port
        assert got["timestamps"][-1][2] > seconds


def test_infeasible_target_is_inf_where_optax_is_finite():
    """A target that needs more frames than there are: optax's dense DP returns
    about -log_epsilon (1e5) over the label count, torch's CTC infinity. The
    port keeps torch's (ROADMAP §3)."""
    from speechflow_tpu.training.losses import CTCLoss as JCTC

    logits = np.random.default_rng(0).normal(size=(1, 3, 5)).astype(np.float32)
    target = np.asarray([[1, 1, 1, 2]], np.int32)  # 1, 1, 1 needs blanks between: 6 frames
    assert 1e4 < float(JCTC()(jnp.asarray(logits), jnp.asarray(target))) < 1e5
    assert float(CTCLoss()(t(logits), t(target))) == float("inf")


def test_file_asr_reads_the_sidecar(tmp_path):
    wav = tmp_path / "a.wav"
    (tmp_path / "a.whisper").write_text('{"text": "hi", "timestamps": [["hi", 0.0, 0.5]]}')
    assert FileASR()(wav) == {"text": "hi", "timestamps": [["hi", 0.0, 0.5]]}
