"""The vocoder's validation metrics of the port against the JAX package's on
SEGS speech and degraded copies of it: MCD, SI-SNR, the YIN periodicity
metrics and wideband PESQ, each within 1e-6 relative (the DSP runs in f32 on
both sides, PESQ in float64 numpy). The pitch RMSE is a root mean square of
differences of F0s that each agree to ~1e-6 of their ~100-500 Hz: it is held
to 1e-4 Hz (measured 5e-6 Hz)."""

from pathlib import Path

import numpy as np
import pytest

from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.models.vocoder import metrics as M
from speechflow_torch.models.vocoder.pesq import pesq_raw, pesq_wb

TOL = 1e-6


def _pair(kind: str):
    files = sorted(Path(__file__).parent.joinpath("data", "SEGS").rglob("*.wav"))[:2]
    real = np.stack([AudioChunk(file_path=f).load(sr=24000).waveform[:48000] for f in files])
    rng = np.random.default_rng(3)
    if kind == "noise":
        fake = real + 0.01 * rng.normal(size=real.shape)
    else:  # a smeared, quieter copy
        fake = 0.7 * np.convolve(real.reshape(-1), np.ones(9) / 9, "same").reshape(real.shape)
    return fake.astype(np.float32), real.astype(np.float32)


@pytest.mark.parametrize("kind", ["noise", "smear"])
def test_metrics_match_jax(kind):
    from speechflow_tpu.models.vocoder import metrics as J

    fake, real = _pair(kind)
    np.testing.assert_allclose(M.mel_cepstral_distortion(fake, real),
                               J.mel_cepstral_distortion(fake, real), rtol=TOL)
    np.testing.assert_allclose(M.si_snr(fake, real), J.si_snr(fake, real), rtol=TOL)
    ours, ref = M.periodicity_metrics(fake, real), J.periodicity_metrics(fake, real)
    assert ours.keys() == ref.keys()
    for k in ref:
        atol = 1e-4 if k == "pitch_rmse_hz" else 1e-9
        np.testing.assert_allclose(ours[k], ref[k], rtol=TOL, atol=atol, err_msg=k)


@pytest.mark.parametrize("kind", ["noise", "smear"])
def test_pesq_matches_jax(kind):
    from speechflow_tpu.models.vocoder import pesq as J

    fake, real = _pair(kind)
    assert pesq_wb(real[0], fake[0], 24000) == pytest.approx(J.pesq_wb(real[0], fake[0], 24000),
                                                             rel=TOL)
    assert pesq_raw(real[1], fake[1], 24000) == pytest.approx(J.pesq_raw(real[1], fake[1], 24000),
                                                              rel=TOL)
