"""DSP ops of the port against ``speechflow_tpu.ops`` (f32, CPU): STFT,
magnitude, overlap-add (strip-sum and scatter branches), ISTFT, the mel
filterbank (exactly), mel projection and its pseudo-inverse, dB and
normalisation, on lengths that are not multiples of the hop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechflow_torch.ops import mel as M
from speechflow_torch.ops import stft as S
from tests.torch_parity import n, t

torch.set_num_threads(1)
TOL = 1e-5


def _wave(rng, *shape):
    return (0.3 * rng.normal(size=shape)).astype(np.float32)


def _close(a, b, tol=TOL):
    a, b = n(a), n(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=tol * max(1.0, float(np.abs(b).max())), rtol=0)


def test_hann_window_and_frames(rng):
    from speechflow_tpu import ops as J

    np.testing.assert_array_equal(n(S.hann_window(400)), n(J.hann_window(400)))
    x = _wave(rng, 2, 1000)
    np.testing.assert_array_equal(n(S.frame_signal(t(x), 256, 100)),
                                  n(J.frame_signal(jnp.asarray(x), 256, 100)))


@pytest.mark.parametrize("n_fft,hop,win,length", [(1024, 256, None, 6001), (256, 64, 200, 999),
                                                  (512, 120, None, 2047)])
def test_stft_and_magnitude(rng, n_fft, hop, win, length):
    from speechflow_tpu import ops as J

    x = _wave(rng, 2, length)
    ref = np.asarray(J.stft(jnp.asarray(x), n_fft, hop, win))
    out = S.stft(t(x), n_fft, hop, win)
    assert out.dtype == torch.complex64 and out.shape[-2] == length // hop + 1
    _close(out.real, ref.real)
    _close(out.imag, ref.imag)
    _close(S.magnitude(t(x), n_fft, hop, win), J.magnitude(jnp.asarray(x), n_fft, hop, win))


@pytest.mark.parametrize("frame,hop", [(1024, 256), (512, 512), (300, 128), (7, 3)])
def test_overlap_add_both_branches(rng, frame, hop):
    from speechflow_tpu import ops as J

    frames = _wave(rng, 2, 3, 9, frame)
    _close(S.overlap_add(t(frames), hop), J.overlap_add(jnp.asarray(frames), hop))


@pytest.mark.parametrize("n_fft,hop,win,length", [(1024, 256, None, 6001), (256, 64, 200, 999),
                                                  (512, 120, None, 2047)])
def test_istft(rng, n_fft, hop, win, length):
    """Random spectra (no analysis/synthesis identity assumed), and the round
    trip of a real signal through both packages."""
    from speechflow_tpu import ops as J

    n_frames = length // hop + 1
    spec = (rng.normal(size=(2, n_frames, n_fft // 2 + 1))
            + 1j * rng.normal(size=(2, n_frames, n_fft // 2 + 1))).astype(np.complex64)
    ref = J.istft(jnp.asarray(spec), n_fft, hop, win)
    out = S.istft(t(spec), n_fft, hop, win)
    assert out.shape[-1] == (n_frames - 1) * hop
    _close(out, ref)
    x = _wave(rng, 2, length)
    back = S.istft(S.stft(t(x), n_fft, hop, win), n_fft, hop, win, length=length - length % hop)
    _close(back, J.istft(J.stft(jnp.asarray(x), n_fft, hop, win), n_fft, hop, win,
                         length=length - length % hop))


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax,htk", [(24000, 1024, 100, 0.0, None, False),
                                                           (22050, 1024, 80, 50.0, 8000.0, False),
                                                           (16000, 512, 40, 0.0, None, True)])
def test_mel_filterbank_and_projection(rng, sr, n_fft, n_mels, fmin, fmax, htk):
    from speechflow_tpu import ops as J

    np.testing.assert_array_equal(M.mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk),
                                  J.mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk))
    mag = np.abs(_wave(rng, 2, 13, n_fft // 2 + 1))
    mel = M.linear_to_mel(t(mag), sr, n_mels, fmin, fmax, htk)
    _close(mel, J.linear_to_mel(jnp.asarray(mag), sr, n_mels, fmin, fmax, htk))
    _close(M.mel_to_linear(mel, sr, n_fft, fmin, fmax, htk),
           J.mel_to_linear(jnp.asarray(n(mel)), sr, n_fft, fmin, fmax, htk))


def test_db_and_normalisation(rng):
    from speechflow_tpu import ops as J

    x = np.abs(_wave(rng, 3, 50)) * np.array([1.0, 1e-6, 10.0], np.float32)[:, None]
    for mult, a_max in ((1.0, None), (20.0, 2.0)):
        db = M.amp_to_db(t(x), mult, 1e-5, a_max)
        _close(db, J.amp_to_db(jnp.asarray(x), mult, 1e-5, a_max))
        _close(M.db_to_amp(db, mult), J.db_to_amp(jnp.asarray(n(db)), mult))
    db = n(M.amp_to_db(t(x)))
    norm = M.normalize_mel(t(db))
    _close(norm, J.normalize_mel(jnp.asarray(db)))
    _close(M.denormalize_mel(norm), J.denormalize_mel(jnp.asarray(n(norm))))


def test_log_mel_features(rng):
    """``MelFeatures`` of the port against the JAX extractor, all N//hop + 1
    frames, with and without normalisation."""
    from flax import nnx

    from speechflow_torch.models.vocoder.feature_extractors import MelFeatures
    from speechflow_tpu.models.vocoder.feature_extractors import MelFeatures as J

    x = _wave(rng, 2, 5000)
    for norm in (False, True):
        ref = J(24000, 1024, 256, 100, normalize=norm, rngs=nnx.Rngs(0))(
            {"waveform": jnp.asarray(x)})
        out = MelFeatures(24000, 1024, 256, 100, normalize=norm)({"waveform": t(x)})
        assert out.shape == (2, 5000 // 256 + 1, 100)
        _close(out, ref)
