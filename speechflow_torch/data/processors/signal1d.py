"""Contour handlers (counterpart of ``speechflow_tpu/data/processors/signal1d.py``):
enhancement, clipping, normalisation, per-utterance averages, pitch wavelets,
resampling along time, and keeping a copy of a field. They run on the host in
the data workers over short per-frame contours (pitch, energy, spectral
flatness), in numpy.

Two behaviours of the JAX handlers, which differ from the reference they were
modelled on, are kept as they are:

- ``signal_enhancement(interpolate_zeros=True, max_zero_interval=t)`` leaves a
  run of at least ``t`` zero frames at zero (a long pause keeps no
  interpolated F0);
- ``pitch_to_wavelet`` computes the ricker wavelet transform directly (scipy
  has no ``signal.cwt`` since 1.15), with the legacy scipy wavelet.
"""

from __future__ import annotations

import typing as tp

import numpy as np
from scipy.signal import savgol_filter

from speechflow_torch.data.core.datasample import SpectrogramDataSample
from speechflow_torch.data.processors import handler
from speechflow_torch.data.processors.text import BOS, EOS, SIL

__all__ = ["signal_enhancement", "clip", "normalize", "average_by_time", "pitch_to_wavelet",
           "timedim_interpolation", "store_field"]

_CONTOURS = {"pitch", "energy", "spectral_flatness"}


def _as_list(attributes: tp.Union[str, tp.List[str]]) -> tp.List[str]:
    return [attributes] if isinstance(attributes, str) else list(attributes)


def _get_contour(ds, attr: str) -> tp.Optional[np.ndarray]:
    if hasattr(ds, attr):
        return getattr(ds, attr)
    if attr in ds.additional:
        return ds.additional[attr]
    raise KeyError(f"attribute '{attr}' not found on {type(ds).__name__}")


def _set_contour(ds, attr: str, values: np.ndarray) -> None:
    if hasattr(ds, attr):
        setattr(ds, attr, values)
    else:
        ds.additional[attr] = values


def _reject_outliers(x: np.ndarray, m: float = 2.0) -> np.ndarray:
    """The values within ``m`` standard deviations of the mean (all if none are)."""
    keep = np.abs(x - x.mean()) < m * x.std()
    return x[keep] if keep.any() else x


@handler(inputs=set(), outputs=set(), optional=_CONTOURS)
def signal_enhancement(ds: SpectrogramDataSample, attributes: tp.Union[str, tp.List[str]],
                       smooth: bool = False, interpolate_zeros: bool = False,
                       set_zero_in_pauses: bool = False,
                       max_zero_interval: tp.Optional[int] = None,
                       smooth_options: tp.Optional[dict] = None) -> SpectrogramDataSample:
    """Clean 1-D contours: linear interpolation over zero frames (runs of at
    least ``max_zero_interval`` frames, and such runs at either end, stay 0),
    Savitzky-Golay smoothing (``window_length`` 5, ``polyorder`` 1, wrapped;
    clipped at 0), and zeros inside pause tokens."""
    for attr in _as_list(attributes):
        values = _get_contour(ds, attr)
        if values is None:
            continue
        values = np.asarray(values, dtype=np.float64).copy()
        if values.ndim != 1:
            raise ValueError(f"'{attr}' must be 1-D, not {values.shape}")

        if interpolate_zeros:
            nz = np.flatnonzero(values != 0)
            if 0 < len(nz) < len(values):
                filled = np.interp(np.arange(len(values)), nz, values[nz])
                if max_zero_interval is not None:
                    t = max(int(max_zero_interval), 2)
                    gap_start = nz[:-1][(nz[1:] - nz[:-1]) > t]
                    for g0, g1 in zip(gap_start, nz[np.searchsorted(nz, gap_start) + 1]):
                        filled[g0 + 1:g1] = 0.0
                    if nz[0] > t:
                        filled[:nz[0]] = 0.0
                    if len(values) - 1 - nz[-1] > t:
                        filled[nz[-1] + 1:] = 0.0
                values = filled

        if smooth:
            opts = dict(window_length=5, polyorder=1, mode="wrap")
            opts.update(smooth_options or {})
            if len(values) > opts["window_length"]:
                values = np.clip(savgol_filter(values, **opts), 0.0, None)

        if set_zero_in_pauses:
            ph_ts = getattr(ds, "phoneme_timestamps", None)
            phonemes = getattr(ds, "phonemes", None)
            hop = getattr(ds, "hop_len", None)
            sr = ds.sample_rate or (ds.audio_chunk.sr if ds.audio_chunk else None)
            if ph_ts is not None and phonemes is not None and hop and sr:
                for (t0, t1), ph in zip(np.asarray(ph_ts), phonemes):
                    if ph in (SIL, BOS, EOS, "", "_"):
                        values[int(t0 * sr / hop):int(t1 * sr / hop)] = 0.0

        _set_contour(ds, attr, values.astype(np.float32))
    return ds


@handler(inputs=set(), outputs=set(), optional=_CONTOURS)
def clip(ds: SpectrogramDataSample, attributes: tp.Union[str, tp.List[str]],
         min_value: tp.Optional[float] = None,
         max_value: tp.Optional[float] = None) -> SpectrogramDataSample:
    for attr in _as_list(attributes):
        values = _get_contour(ds, attr)
        if values is not None:
            _set_contour(ds, attr, np.clip(values, min_value, max_value))
    return ds


@handler(inputs=set(), outputs={"ranges"}, optional=_CONTOURS)
def normalize(ds: SpectrogramDataSample, attributes: tp.Union[str, tp.List[str]],
              normalize_by: str = "sample", method: str = "minmax",
              filter_outliers: bool = False, quantile: float = 0.98,
              min_value: tp.Optional[float] = None, max_value: tp.Optional[float] = None,
              ranges=None) -> SpectrogramDataSample:
    """Scale 1-D contours to [0, 1] (``minmax``, ``quantile``) or shift them to
    0 mean over 4 standard deviations (``z-norm``), by the sample's own
    values (pitch's voiced ones), the speaker's (``normalize_by="speaker"``:
    ``ranges``, the ``StatisticsRange`` singleton the pipeline binds), or
    ``constant`` bounds; ``ds.ranges[attr]`` records (lo, hi, span)."""
    if ds.ranges is None:
        ds.ranges = {}
    for attr in _as_list(attributes):
        values = _get_contour(ds, attr)
        if values is None:
            continue
        values = np.asarray(values, dtype=np.float32).copy()
        if values.ndim != 1:
            continue

        if normalize_by == "constant":
            if min_value is None or max_value is None:
                raise ValueError("normalize_by='constant' needs min_value and max_value")
            a_min, a_max = float(min_value), float(max_value)
        elif normalize_by == "speaker":
            if ranges is None:
                raise ValueError(
                    "normalize(normalize_by='speaker') needs the StatisticsRange "
                    "singleton in singleton_handlers")
            lo, hi, mean, std = ranges.get(attr, getattr(ds, "speaker_name", None))
            if method == "z-norm":
                a_min, a_max = float(mean), float(mean + 4.0 * max(std, 1e-6))
            else:
                a_min, a_max = float(lo), float(hi)
        else:
            pool = values[values != 0] if "pitch" in attr else values
            if pool.size == 0:
                pool = values
            if filter_outliers:
                pool = _reject_outliers(pool)
            if method == "quantile":
                a_min = float(np.quantile(pool, 1 - quantile))
                a_max = float(np.quantile(pool, quantile))
            elif method == "z-norm":
                mean, std = float(pool.mean()), float(pool.std())
                a_min, a_max = mean, mean + 4.0 * max(std, 1e-6)
            else:
                a_min, a_max = float(pool.min()), float(pool.max())
            if min_value is not None:
                a_min = float(min_value)
            if max_value is not None:
                a_max = float(max_value)

        span = max(a_max - a_min, 1e-6)
        _set_contour(ds, attr, ((values - a_min) / span).astype(np.float32))
        ds.ranges[attr] = np.asarray([a_min, a_max, span], dtype=np.float32)
    return ds


@handler(inputs=set(), outputs={"averages"}, optional=_CONTOURS | {"durations"})
def average_by_time(ds: SpectrogramDataSample, attributes: tp.Union[str, tp.List[str]],
                    use_quantile: bool = False, quantile: float = 0.95,
                    min_value: tp.Optional[float] = None) -> SpectrogramDataSample:
    """Per-utterance means of contours (values above ``min_value``; outliers
    beyond 2 standard deviations left out, or with ``use_quantile`` the values
    clipped to the quantiles), and ``rate``, tokens a second, into
    ``ds.averages``."""
    ds.averages = dict(ds.averages or {})
    for attr in _as_list(attributes):
        if attr == "rate":
            n_tok = getattr(ds, "n_tokens", 0)
            dur = ds.audio_chunk.duration if ds.audio_chunk is not None else 0.0
            ds.averages["rate"] = np.float32(n_tok / dur if dur else 0.0)
            continue
        values = _get_contour(ds, attr)
        if values is None:
            continue
        values = np.asarray(values, dtype=np.float32).ravel()
        if min_value is not None:
            values = values[values > min_value]
        if values.size == 0:
            ds.averages[attr] = np.float32(0.0)
            continue
        if use_quantile:
            values = np.clip(values, np.quantile(values, 1 - quantile),
                             np.quantile(values, quantile))
        else:
            values = _reject_outliers(values)
        ds.averages[attr] = np.float32(values.mean())
    return ds


def _ricker(points: int, a: float) -> np.ndarray:
    """The ricker (Mexican hat) wavelet of legacy ``scipy.signal.ricker``."""
    A = 2.0 / (np.sqrt(3.0 * a) * np.pi ** 0.25)
    x = np.arange(points) - (points - 1.0) / 2.0
    xsq = (x / a) ** 2
    return A * (1.0 - xsq) * np.exp(-xsq / 2.0)


@handler(inputs={"pitch"}, outputs={"pitch"})
def pitch_to_wavelet(ds: SpectrogramDataSample, num_bands: int = 100) -> SpectrogramDataSample:
    """The F0 contour's ricker-wavelet transform at widths 1..``num_bands``:
    pitch becomes (T, num_bands)."""
    x = np.asarray(ds.pitch, dtype=np.float64).ravel()
    out = np.empty((num_bands, len(x)), dtype=np.float64)
    for i, width in enumerate(range(1, num_bands + 1)):
        out[i] = np.convolve(x, _ricker(min(10 * width, len(x)), width), mode="same")
    ds.pitch = out.T.astype(np.float32)
    return ds


@handler(inputs=set(), outputs=set(), optional=_CONTOURS | {"ssl_feat", "mel"})
def timedim_interpolation(ds: SpectrogramDataSample, features: tp.Union[str, tp.List[str]],
                          shape_as: str = "mel", mode: str = "linear",
                          ratio: float = 1.0) -> SpectrogramDataSample:
    """Resample ``features`` along time (``linear`` or ``nearest``) to ``ratio``
    times the frames of ``shape_as``."""
    target = getattr(ds, shape_as, None)
    if target is None:
        raise KeyError(f"shape_as '{shape_as}' not set on the sample")
    t_out = int(ratio * target.shape[0])
    for name in _as_list(features):
        feat = getattr(ds, name, None) if hasattr(ds, name) else ds.additional.get(name)
        if feat is None:
            continue
        t_in = feat.shape[0]
        if t_in == t_out:
            continue
        pos = np.linspace(0.0, t_in - 1.0, t_out)
        if mode == "nearest":
            res = feat[np.round(pos).astype(np.int64)]
        else:
            i0 = np.floor(pos).astype(np.int64)
            i1 = np.minimum(i0 + 1, t_in - 1)
            w = (pos - i0).astype(np.float32)
            if feat.ndim == 1:
                res = feat[i0] * (1 - w) + feat[i1] * w
            else:
                res = feat[i0] * (1 - w)[:, None] + feat[i1] * w[:, None]
        _set_contour(ds, name, res.astype(np.float32))
    return ds


@handler(inputs=set(), outputs=set())
def store_field(ds: SpectrogramDataSample, key: str, as_key: str) -> SpectrogramDataSample:
    """Copy field ``key`` into ``ds.additional[as_key]`` before a later handler
    overwrites it."""
    attr = getattr(ds, key, None) if hasattr(ds, key) else ds.additional.get(key)
    if attr is not None:
        ds.additional[as_key] = np.copy(attr) if isinstance(attr, np.ndarray) else attr
    return ds
