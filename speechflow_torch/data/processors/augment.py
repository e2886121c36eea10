"""Waveform and spectrogram augmentations (counterpart of
``speechflow_tpu/data/processors/augment.py``): gain and gain curves, clipping,
coloured and background noise, pitch shift and time stretch, a band-stop
frequency mask, a telephone channel, vocal-tract length perturbation, room
reverb (measured or synthetic impulse responses), rhythm changes and flattened
pitch through WSOLA, SpecAugment masks, mel blur and noise. Host numpy and
scipy, in the data workers.

Each handler applies with probability ``p``. Its generator is
``np.random.default_rng(seed)``, drawn in the JAX handler's order, so a seeded
handler is the JAX one bit for bit. Without a seed it is seeded from
``hash((ds.uid, ds.index))``, as in the JAX package: Python salts that hash
per process, so within one process a sample gets the same draw every epoch, and
another process (a loader worker, a rerun) gets other draws.
"""

from __future__ import annotations

import typing as tp

import numpy as np
from scipy.signal import resample_poly

from speechflow_torch.data.core.datasample import AudioDataSample, SpectrogramDataSample
from speechflow_torch.data.processors import handler

__all__ = ["aug_gain", "aug_clipping", "aug_colored_noise", "aug_pitch_shift",
           "aug_time_stretch", "aug_gain_curve", "aug_frequency_mask", "aug_gsm_simulation",
           "aug_vtlp", "aug_room_impulse_response", "aug_background_noise",
           "aug_change_rhythm", "aug_monotonic_speech", "aug_spec_blur", "aug_spec_noise",
           "aug_spec_augment"]


def _rng(ds, seed):
    if seed is not None:
        return np.random.default_rng(seed)
    return np.random.default_rng(abs(hash((ds.uid, ds.index))) % (2**32))


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def aug_gain(ds: AudioDataSample, p: float = 0.5, min_gain: float = 0.5,
             max_gain: float = 1.5, seed: tp.Optional[int] = None) -> AudioDataSample:
    rng = _rng(ds, seed)
    if rng.uniform() < p:
        ds.audio_chunk.volume(float(rng.uniform(min_gain, max_gain)))
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def aug_clipping(ds: AudioDataSample, p: float = 0.3, min_percentile: float = 0.9,
                 seed: tp.Optional[int] = None) -> AudioDataSample:
    rng = _rng(ds, seed)
    if rng.uniform() < p:
        wav = ds.audio_chunk.waveform
        thr = float(np.quantile(np.abs(wav), rng.uniform(min_percentile, 1.0)))
        ds.audio_chunk.data = np.clip(wav, -thr, thr).astype(np.float32)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def aug_colored_noise(ds: AudioDataSample, p: float = 0.3, snr_db_min: float = 15.0,
                      snr_db_max: float = 40.0, color: str = "white",
                      seed: tp.Optional[int] = None) -> AudioDataSample:
    rng = _rng(ds, seed)
    if rng.uniform() >= p:
        return ds
    wav = ds.audio_chunk.waveform
    noise = rng.standard_normal(len(wav)).astype(np.float32)
    if color == "pink":  # 1/f shaping in the frequency domain
        spec = np.fft.rfft(noise)
        f = np.maximum(np.arange(len(spec)), 1.0)
        spec = spec / np.sqrt(f)
        noise = np.fft.irfft(spec, n=len(wav)).astype(np.float32)
    snr = rng.uniform(snr_db_min, snr_db_max)
    sig_p = np.mean(wav**2) + 1e-12
    noise_p = np.mean(noise**2) + 1e-12
    scale = np.sqrt(sig_p / (noise_p * 10 ** (snr / 10)))
    ds.audio_chunk.data = (wav + scale * noise).astype(np.float32)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def aug_pitch_shift(ds: AudioDataSample, p: float = 0.3, max_semitones: float = 2.0,
                    seed: tp.Optional[int] = None) -> AudioDataSample:
    """Resample-based pitch shift (changes duration back via second resample)."""
    rng = _rng(ds, seed)
    if rng.uniform() >= p:
        return ds
    semis = float(rng.uniform(-max_semitones, max_semitones))
    rate = 2.0 ** (semis / 12.0)
    wav = ds.audio_chunk.waveform
    n = len(wav)
    up, down = max(1, int(round(1000 / rate))), 1000
    shifted = resample_poly(wav, up, down)
    # stretch back to original length (crude PSOLA-free approximation)
    idx = np.linspace(0, len(shifted) - 1, n)
    ds.audio_chunk.data = np.interp(idx, np.arange(len(shifted)), shifted).astype(np.float32)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def aug_time_stretch(ds: AudioDataSample, p: float = 0.3, min_rate: float = 0.9,
                     max_rate: float = 1.1, seed: tp.Optional[int] = None) -> AudioDataSample:
    rng = _rng(ds, seed)
    if rng.uniform() >= p:
        return ds
    rate = float(rng.uniform(min_rate, max_rate))
    wav = ds.audio_chunk.waveform
    up, down = max(1, int(round(1000 / rate))), 1000
    ds.audio_chunk.data = resample_poly(wav, up, down).astype(np.float32)
    return ds


def _random_curve(rng, n_points: int, min_ratio: float, max_ratio: float,
                  size: int) -> np.ndarray:
    pts = rng.uniform(min_ratio, max_ratio, size=n_points)
    xs = np.linspace(0, size - 1, n_points)
    return np.interp(np.arange(size), xs, pts).astype(np.float32)


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def aug_gain_curve(ds: AudioDataSample, p: float = 0.5, min_points: int = 2,
                   max_points: int = 5, min_ratio: float = 0.5, max_ratio: float = 2.0,
                   seed: tp.Optional[int] = None) -> AudioDataSample:
    """Time-varying random gain (reference: audio_augmentation.py:223 gain_curve)."""
    rng = _rng(ds, seed)
    if rng.uniform() >= p:
        return ds
    wav = ds.audio_chunk.waveform
    curve = _random_curve(rng, int(rng.integers(min_points, max_points + 1)),
                          min_ratio, max_ratio, len(wav))
    ds.audio_chunk.data = np.clip(wav * curve, -1.0, 1.0).astype(np.float32)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def aug_frequency_mask(ds: AudioDataSample, p: float = 0.3,
                       min_frequency_band: float = 0.0,
                       max_frequency_band: float = 0.25,
                       seed: tp.Optional[int] = None) -> AudioDataSample:
    """Bandstop a random frequency band (reference: audio_augmentation.py:316
    frequency_mask, butterworth bandstop)."""
    from scipy.signal import butter, sosfiltfilt

    rng = _rng(ds, seed)
    if rng.uniform() >= p:
        return ds
    sr = ds.audio_chunk.sr
    bw = rng.uniform(min_frequency_band, max_frequency_band) * sr / 2
    bw = max(bw, 32.0)
    f_lo = rng.uniform(16.0, sr / 2 - bw - 1)
    sos = butter(4, [f_lo, f_lo + bw], btype="bandstop", fs=sr, output="sos")
    ds.audio_chunk.data = sosfiltfilt(sos, ds.audio_chunk.waveform).astype(np.float32)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def aug_gsm_simulation(ds: AudioDataSample, p: float = 0.3,
                       seed: tp.Optional[int] = None) -> AudioDataSample:
    """Telephone-channel simulation (reference: audio_augmentation.py:364
    gsm_simulation via sox lowpass+compand+rate 8k+GSM codec).

    Offline equivalent: 4 kHz lowpass -> soft dynamic-range companding ->
    8 kHz resample -> 8-bit mu-law quantisation (the codec artefact) ->
    resample back to the native rate."""
    rng = _rng(ds, seed)
    if rng.uniform() >= p:
        return ds
    wav = ds.audio_chunk.waveform
    sr = ds.audio_chunk.sr
    from scipy.signal import butter, sosfiltfilt

    sos = butter(6, 4000.0, btype="low", fs=sr, output="sos")
    x = sosfiltfilt(sos, wav)
    # compand: mild compression of the upper dynamic range
    x = np.sign(x) * np.abs(x) ** 0.85
    x8 = resample_poly(x, 8000, sr)
    mu = 255.0
    comp = np.sign(x8) * np.log1p(mu * np.minimum(np.abs(x8), 1.0)) / np.log1p(mu)
    q = np.round(comp * 127.0) / 127.0
    dec = np.sign(q) * (np.expm1(np.abs(q) * np.log1p(mu))) / mu
    y = resample_poly(dec, sr, 8000)
    n = len(wav)
    y = np.pad(y, (0, max(0, n - len(y))))[:n]
    ds.audio_chunk.data = y.astype(np.float32)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def aug_vtlp(ds: AudioDataSample, p: float = 0.3, alpha_min: float = 0.9,
             alpha_max: float = 1.1, fhi: float = 4800.0,
             seed: tp.Optional[int] = None) -> AudioDataSample:
    """Vocal-tract length perturbation (reference: audio_augmentation.py:523):
    piecewise-linear warp of the STFT frequency axis, resynthesised by ISTFT.

    Vectorised scatter over bins instead of the reference's per-bin loop."""
    from scipy.signal import istft as sp_istft
    from scipy.signal import stft as sp_stft

    rng = _rng(ds, seed)
    if rng.uniform() >= p:
        return ds
    wav = ds.audio_chunk.waveform
    sr = ds.audio_chunk.sr
    alpha = float(rng.uniform(alpha_min, alpha_max))
    n_fft = 1024
    _, _, S = sp_stft(wav, fs=sr, nperseg=n_fft, noverlap=3 * n_fft // 4)
    K = S.shape[0]

    # one-sided STFT bins span 0..sr/2; warping within that range keeps the
    # effective warp factor alpha
    fs_half = sr / 2.0
    f = np.linspace(0, fs_half, K)
    scale = fhi * min(alpha, 1.0)
    f_boundary = scale / alpha
    f_warp = np.where(
        f <= f_boundary,
        f * alpha,
        fs_half - (fs_half - scale) / (fs_half - scale / alpha) * (fs_half - f),
    )
    f_warp = np.clip(f_warp, 0.0, fs_half) * (K - 1) / fs_half

    lo = np.floor(f_warp).astype(np.int64)
    w_up = (f_warp - lo).astype(S.real.dtype)
    new_S = np.zeros_like(S)
    inner = np.arange(1, K - 1)
    np.add.at(new_S, lo[inner], (1.0 - w_up[inner])[:, None] * S[inner])
    np.add.at(new_S, np.minimum(lo[inner] + 1, K - 1), w_up[inner][:, None] * S[inner])
    new_S[0] += S[0]
    new_S[K - 1] += S[K - 1]

    _, y = sp_istft(new_S, fs=sr, nperseg=n_fft, noverlap=3 * n_fft // 4)
    n = len(wav)
    y = np.pad(y, (0, max(0, n - len(y))))[:n]
    ds.audio_chunk.data = y.astype(np.float32)
    return ds


def _synthetic_rir(rng, sr: int, rt60: float) -> np.ndarray:
    """Exponentially decaying noise IR with a direct-path spike — the standard
    image-method surrogate when no measured IRs are available offline."""
    n = int(rt60 * sr)
    t = np.arange(n) / sr
    decay = np.exp(-6.9078 * t / rt60)  # ln(1e3): -60 dB at rt60
    ir = rng.standard_normal(n) * decay
    ir[0] = np.abs(ir).max() * 2.0  # direct path dominates
    return (ir / np.sqrt(np.sum(ir**2) + 1e-12)).astype(np.float32)


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def aug_room_impulse_response(ds: AudioDataSample, p: float = 0.3,
                              ir_paths: tp.Optional[tp.Sequence[str]] = None,
                              min_rt60: float = 0.1, max_rt60: float = 0.6,
                              seed: tp.Optional[int] = None) -> AudioDataSample:
    """Reverb via IR convolution (reference: audio_augmentation.py:634
    room_impulse_response over torch-audiomentations ApplyImpulseResponse).

    Accepts measured IR wav paths; falls back to synthetic exponential-decay
    IRs with a random RT60 when none are provided."""
    from scipy.signal import fftconvolve

    rng = _rng(ds, seed)
    if rng.uniform() >= p:
        return ds
    sr = ds.audio_chunk.sr
    if ir_paths:
        from speechflow_torch.io.audio import AudioChunk

        path = ir_paths[int(rng.integers(0, len(ir_paths)))]
        ir = AudioChunk(file_path=path).load(sr=sr).waveform
        ir = ir / np.sqrt(np.sum(ir**2) + 1e-12)
    else:
        ir = _synthetic_rir(rng, sr, float(rng.uniform(min_rt60, max_rt60)))
    wav = ds.audio_chunk.waveform
    wet = fftconvolve(wav, ir, mode="full")[: len(wav)]
    peak = np.abs(wet).max() + 1e-12
    if peak > 1.0:
        wet = wet / peak
    ds.audio_chunk.data = wet.astype(np.float32)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def aug_background_noise(ds: AudioDataSample, p: float = 0.3,
                         background_paths: tp.Optional[tp.Sequence[str]] = None,
                         min_snr_in_db: float = 7.0, max_snr_in_db: float = 20.0,
                         seed: tp.Optional[int] = None) -> AudioDataSample:
    """Additive background noise at random SNR (reference:
    audio_augmentation.py:581 background_noise). With no noise corpus it
    falls back to band-shaped babble-like noise (pink noise through a random
    second-order resonance) so the handler is usable fully offline."""
    rng = _rng(ds, seed)
    if rng.uniform() >= p:
        return ds
    wav = ds.audio_chunk.waveform
    sr = ds.audio_chunk.sr
    n = len(wav)
    if background_paths:
        from speechflow_torch.io.audio import AudioChunk

        path = background_paths[int(rng.integers(0, len(background_paths)))]
        noise = AudioChunk(file_path=path).load(sr=sr).waveform
        if len(noise) < n:
            noise = np.tile(noise, n // max(len(noise), 1) + 1)
        start = int(rng.integers(0, len(noise) - n + 1))
        noise = noise[start : start + n]
    else:
        from scipy.signal import sosfilt

        white = rng.standard_normal(n)
        spec = np.fft.rfft(white)
        spec = spec / np.sqrt(np.maximum(np.arange(len(spec)), 1.0))
        pink = np.fft.irfft(spec, n=n)
        f0 = float(rng.uniform(300.0, 2000.0))
        from scipy.signal import butter

        sos = butter(2, [max(f0 * 0.5, 50.0), min(f0 * 2.0, sr / 2 - 1)],
                     btype="band", fs=sr, output="sos")
        noise = sosfilt(sos, pink)
    snr = rng.uniform(min_snr_in_db, max_snr_in_db)
    sig_p = np.mean(wav**2) + 1e-12
    noise_p = np.mean(noise**2) + 1e-12
    scale = np.sqrt(sig_p / (noise_p * 10 ** (snr / 10)))
    ds.audio_chunk.data = (wav + scale * noise).astype(np.float32)
    return ds


def _tsm_wsola(wav: np.ndarray, rate: float, sr: int) -> np.ndarray:
    """Pitch-preserving time-scale modification (WSOLA); rate > 1 speeds up."""
    if abs(rate - 1.0) < 1e-3 or len(wav) < 2048:
        return wav
    win = int(0.025 * sr) // 2 * 2  # ~25 ms, even
    hop_out = win // 2
    hop_in = int(round(hop_out * rate))
    tol = win // 4
    window = np.hanning(win).astype(np.float32)
    n_out = int(len(wav) / rate)
    out = np.zeros(n_out + win, np.float32)
    norm = np.zeros(n_out + win, np.float32)
    pos_in, pos_out = 0, 0
    prev_tail = None
    while pos_out + win <= n_out and pos_in + win + tol <= len(wav):
        if prev_tail is None or pos_in - tol < 0:
            best = pos_in
        else:  # search the offset whose start best continues the previous tail
            lo = max(pos_in - tol, 0)
            hi = min(pos_in + tol, len(wav) - win)
            segs = np.lib.stride_tricks.sliding_window_view(
                wav[lo : hi + hop_out], hop_out
            )[: hi - lo + 1 : 1]
            scores = segs @ prev_tail
            best = lo + int(np.argmax(scores))
        seg = wav[best : best + win]
        out[pos_out : pos_out + win] += seg * window
        norm[pos_out : pos_out + win] += window
        tail = wav[best + hop_out : best + 2 * hop_out].astype(np.float32)
        prev_tail = tail if len(tail) == hop_out else None
        pos_out += hop_out
        pos_in += hop_in
    out = out[:n_out] / np.maximum(norm[:n_out], 1e-3)
    return out.astype(np.float32)


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def aug_change_rhythm(ds: AudioDataSample, p: float = 0.3, mode: str = "up",
                      seg_size: float = 0.16, max_rate: float = 1.2,
                      min_rate: float = 0.8,
                      seed: tp.Optional[int] = None) -> AudioDataSample:
    """Segment-wise rhythm modification (reference: audio_augmentation.py:407
    change_rhythm): a rate curve (constant/fsf/parabola/down/up/question/
    stress) applied per ~160 ms segment with pitch-preserving WSOLA."""
    rng = _rng(ds, seed)
    if rng.uniform() >= p:
        return ds
    wav = ds.audio_chunk.waveform
    sr = ds.audio_chunk.sr
    seg = max(int(seg_size * sr), 256)
    n_seg = max(len(wav) // seg, 1)
    x = np.arange(n_seg, dtype=np.float64)
    if mode == "constant":
        rates = np.full(n_seg, (max_rate + min_rate) / 2)
    elif mode == "fsf":
        rates = np.full(n_seg, max_rate)
        rates[n_seg // 3 : 2 * n_seg // 3] = min_rate
    elif mode == "parabola":
        a = 4 * (min_rate - max_rate) / max(n_seg * n_seg, 1)
        rates = a * (x - n_seg / 2) ** 2 + max_rate
    elif mode == "down":
        rates = (min_rate - max_rate) / n_seg * x + max_rate
    elif mode == "up":
        rates = (max_rate - min_rate) / n_seg * x + min_rate
    elif mode == "question":
        rates = np.ones(n_seg)
        k = 4 * (max_rate - 1) / n_seg
        tail = x >= n_seg * 0.75
        rates[tail] = np.maximum(1.0, k * x[tail] - 3 * max_rate + 4)
    elif mode == "stress":
        rates = np.ones(n_seg)
        k = 4 * (1 - max_rate) / n_seg
        mid = (x >= n_seg * 0.5) & (x < n_seg * 0.75)
        rates[mid] = k * x[mid] + 3 * max_rate - 2
    elif mode == "random":
        rates = rng.uniform(min_rate, max_rate, n_seg)
    else:
        raise ValueError(mode)
    pieces = []
    for i in range(n_seg):
        chunk = wav[i * seg : (i + 1) * seg] if i < n_seg - 1 else wav[i * seg :]
        pieces.append(_tsm_wsola(chunk, float(rates[i]), sr))
    ds.audio_chunk.data = np.concatenate(pieces).astype(np.float32)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"audio_chunk"})
def aug_monotonic_speech(ds: AudioDataSample, p: float = 0.3, frame_s: float = 0.1,
                         seed: tp.Optional[int] = None) -> AudioDataSample:
    """Flatten the pitch contour to its voiced mean (reference:
    audio_augmentation.py:489 monotonic_speech via the WORLD vocoder).

    Offline equivalent without WORLD: per ~100 ms frame, estimate F0 by
    autocorrelation, resample the frame by f0/f0_mean (shifting its pitch to
    the mean) and WSOLA-stretch it back to the original frame length."""
    rng = _rng(ds, seed)
    if rng.uniform() >= p:
        return ds
    wav = ds.audio_chunk.waveform
    sr = ds.audio_chunk.sr
    frame = max(int(frame_s * sr), 512)
    n_frames = max(len(wav) // frame, 1)
    lag_min, lag_max = int(sr / 500), int(sr / 60)

    def frame_f0(seg):
        seg = seg - seg.mean()
        if np.sum(seg**2) < 1e-6:
            return 0.0
        ac = np.correlate(seg, seg, mode="full")[len(seg) - 1 :]
        if len(ac) <= lag_max:
            return 0.0
        lag = lag_min + int(np.argmax(ac[lag_min:lag_max]))
        if ac[lag] < 0.3 * ac[0]:
            return 0.0  # unvoiced
        return sr / lag

    f0s = np.array([frame_f0(wav[i * frame : (i + 1) * frame].astype(np.float64))
                    for i in range(n_frames)])
    voiced = f0s[f0s > 0]
    if len(voiced) == 0:
        return ds
    f0_mean = float(np.mean(voiced))
    pieces = []
    for i in range(n_frames):
        chunk = wav[i * frame : (i + 1) * frame] if i < n_frames - 1 else wav[i * frame :]
        if f0s[i] <= 0 or len(chunk) < 1024:
            pieces.append(chunk)
            continue
        ratio = f0_mean / f0s[i]
        ratio = float(np.clip(ratio, 0.7, 1.4))
        up = max(1, int(round(1000 / ratio)))
        shifted = resample_poly(chunk, up, 1000)  # pitch * ratio, length / ratio
        restored = _tsm_wsola(shifted.astype(np.float32), len(shifted) / len(chunk), sr)
        restored = np.pad(restored, (0, max(0, len(chunk) - len(restored))))[: len(chunk)]
        pieces.append(restored)
    ds.audio_chunk.data = np.concatenate(pieces).astype(np.float32)
    return ds


@handler(inputs={"mel"}, outputs={"mel"})
def aug_spec_blur(ds: SpectrogramDataSample, p: float = 0.3,
                  max_sigma: float = 0.75,
                  seed: tp.Optional[int] = None) -> SpectrogramDataSample:
    """Gaussian blur of the mel (reference: spectrogram_augmentation.py:61)."""
    from scipy.ndimage import gaussian_filter

    rng = _rng(ds, seed)
    if rng.uniform() >= p:
        return ds
    sigma = float(rng.uniform(0.0, max_sigma))
    if sigma > 1e-3:
        ds.mel = gaussian_filter(ds.mel, sigma=sigma).astype(np.float32)
    return ds


@handler(inputs={"mel"}, outputs={"mel"})
def aug_spec_noise(ds: SpectrogramDataSample, p: float = 0.3, scale: float = 0.05,
                   seed: tp.Optional[int] = None) -> SpectrogramDataSample:
    rng = _rng(ds, seed)
    if rng.uniform() < p:
        ds.mel = (ds.mel + scale * rng.standard_normal(ds.mel.shape)).astype(np.float32)
    return ds


@handler(inputs={"mel"}, outputs={"mel"})
def aug_spec_augment(ds: SpectrogramDataSample, p: float = 0.5, n_time_masks: int = 2,
                     time_mask_width: int = 20, n_freq_masks: int = 2,
                     freq_mask_width: int = 12, mask_value: tp.Optional[float] = None,
                     seed: tp.Optional[int] = None) -> SpectrogramDataSample:
    rng = _rng(ds, seed)
    if rng.uniform() >= p:
        return ds
    mel = ds.mel.copy()
    t, f = mel.shape
    fill = mel.min() if mask_value is None else mask_value
    for _ in range(n_time_masks):
        w = int(rng.integers(1, max(2, time_mask_width)))
        s = int(rng.integers(0, max(1, t - w)))
        mel[s : s + w, :] = fill
    for _ in range(n_freq_masks):
        w = int(rng.integers(1, max(2, freq_mask_width)))
        s = int(rng.integers(0, max(1, f - w)))
        mel[:, s : s + w] = fill
    ds.mel = mel
    return ds
