"""Waveform handlers (counterpart of ``speechflow_tpu/data/processors/audio.py``):
loading, trimming, padding and level, resampling, pre-emphasis, mu-law,
dither, and ``denoise``. Each takes an ``AudioDataSample`` and changes its
``audio_chunk`` in place (``mu_law_encode_audio`` sets ``mu_law_waveform``)."""

from __future__ import annotations

import typing as tp

import numpy as np

from speechflow_torch.data.core.datasample import AudioDataSample
from speechflow_torch.data.processors import handler

__all__ = ["load_audio", "trim_audio", "random_chunk", "pad_audio", "multiple_audio",
           "resample_audio", "preemphasis_audio", "volume_normalize", "loudness_normalize",
           "mu_law_encode_audio", "dither_audio", "denoise"]


@handler(outputs={"audio_chunk", "sample_rate"})
def load_audio(ds: AudioDataSample, sample_rate: tp.Optional[int] = None) -> AudioDataSample:
    ds.audio_chunk.load(sr=sample_rate)
    ds.sample_rate = ds.audio_chunk.sr
    ds.transform_params.setdefault("load_audio", {})["sample_rate"] = ds.sample_rate
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def trim_audio(ds: AudioDataSample, begin: float = 0.0,
               end: tp.Optional[float] = None) -> AudioDataSample:
    ds.audio_chunk.trim(begin, end)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def random_chunk(ds: AudioDataSample, chunk_duration: float = 1.0,
                 seed: tp.Optional[int] = None) -> AudioDataSample:
    """A random crop of ``chunk_duration`` seconds (``np.random.default_rng(seed)``:
    fresh entropy per call without a seed); a shorter sample is zero-padded."""
    dur = ds.audio_chunk.duration
    if dur > chunk_duration:
        begin = float(np.random.default_rng(seed).uniform(0.0, dur - chunk_duration))
        ds.audio_chunk.trim(begin, begin + chunk_duration)
    else:
        ds.audio_chunk.pad(0.0, chunk_duration - dur)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def pad_audio(ds: AudioDataSample, left_s: float = 0.0, right_s: float = 0.0
              ) -> AudioDataSample:
    ds.audio_chunk.pad(left_s, right_s)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def multiple_audio(ds: AudioDataSample, hop: int = 256) -> AudioDataSample:
    ds.audio_chunk.multiple(hop)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def resample_audio(ds: AudioDataSample, sample_rate: int = 24000) -> AudioDataSample:
    ds.audio_chunk.resample(sample_rate)
    ds.sample_rate = sample_rate
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def preemphasis_audio(ds: AudioDataSample, coeff: float = 0.97) -> AudioDataSample:
    ds.audio_chunk.preemphasis(coeff)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def volume_normalize(ds: AudioDataSample, peak: float = 0.95) -> AudioDataSample:
    ds.audio_chunk.normalize(peak)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def loudness_normalize(ds: AudioDataSample, target_dbfs: float = -23.0) -> AudioDataSample:
    """Scale to an RMS of ``target_dbfs`` dB full scale."""
    wav = ds.audio_chunk.waveform
    rms = float(np.sqrt(np.mean(wav**2) + 1e-12))
    target = 10.0 ** (target_dbfs / 20.0)
    ds.audio_chunk.data = (wav * (target / max(rms, 1e-9))).astype(np.float32)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"mu_law_waveform"})
def mu_law_encode_audio(ds: AudioDataSample, mu: int = 255) -> AudioDataSample:
    ds.mu_law_waveform = ds.audio_chunk.mu_law_encode(mu)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def dither_audio(ds: AudioDataSample, amount: float = 1e-5,
                 seed: tp.Optional[int] = None) -> AudioDataSample:
    """Add ``amount`` times standard normal noise (``np.random.default_rng(seed)``:
    fresh entropy per call without a seed)."""
    rng = np.random.default_rng(seed)
    wav = ds.audio_chunk.waveform
    ds.audio_chunk.data = (wav + amount * rng.standard_normal(len(wav))).astype(np.float32)
    return ds


_DENOISERS: tp.Dict[str, tp.Any] = {}


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def denoise(ds: AudioDataSample, model_ckpt: tp.Optional[str] = None,
            strength: float = 1.0) -> AudioDataSample:
    """With ``model_ckpt`` (a ``WaveDenoiser`` saved with ``save_module``, either
    package's; loaded once per path, on the GPU), ``strength`` mixes its output
    into the waveform. Without it, spectral subtraction on the host (scipy's
    STFT, 1024-sample frames at 75 % overlap): the mean magnitude of the
    quietest 10 % of frames, times ``strength``, is subtracted, the phase kept."""
    wav = ds.audio_chunk.waveform
    if model_ckpt:
        import torch

        if model_ckpt not in _DENOISERS:
            from speechflow_torch.models.denoiser import WaveDenoiser, WaveDenoiserParams
            from speechflow_torch.utils.state_io import load_module

            _DENOISERS[model_ckpt], _ = load_module(WaveDenoiser, WaveDenoiserParams,
                                                    model_ckpt)
        model = _DENOISERS[model_ckpt]
        dev = next(model.parameters()).device
        x = torch.from_numpy(np.ascontiguousarray(wav[None], np.float32)).to(dev)
        with torch.inference_mode():
            den = model(x)[0].float().cpu().numpy()
        ds.audio_chunk.data = ((1.0 - strength) * wav + strength * den[:len(wav)]
                               ).astype(np.float32)
        return ds

    from scipy.signal import istft as sp_istft
    from scipy.signal import stft as sp_stft

    n_fft = 1024
    _, _, spec = sp_stft(wav, nperseg=n_fft, noverlap=3 * n_fft // 4)
    mag, phase = np.abs(spec), np.angle(spec)
    quiet = np.argsort(mag.sum(axis=0))[:max(int(0.1 * mag.shape[1]), 1)]
    noise_profile = mag[:, quiet].mean(axis=1, keepdims=True)
    mag = np.maximum(mag - strength * noise_profile, 0.0)
    _, out = sp_istft(mag * np.exp(1j * phase), nperseg=n_fft, noverlap=3 * n_fft // 4)
    out = np.pad(out, (0, max(0, len(wav) - len(out))))[:len(wav)]
    ds.audio_chunk.data = out.astype(np.float32)
    return ds
