"""Alignment-derived handlers (counterpart of
``speechflow_tpu/data/processors/tts.py``): pauses from the text (stage 1 of
forced alignment) or from the timestamps' gaps, per-token frame durations that
sum to the mel's length, token-level pitch and energy, the stop-gate target,
tokens per word, fades inside pauses, the frame-level reciprocal durations and
the frame-level transcription."""

from __future__ import annotations

import typing as tp

import numpy as np

from speechflow_torch.data.core.datasample import TTSDataSample
from speechflow_torch.data.processors import handler
from speechflow_torch.data.processors.text import SIL
from speechflow_torch.io.timestamps import Timestamps

__all__ = ["add_pauses_from_text", "add_pauses_from_timestamps", "calc_durations",
           "aggregate_pitch", "aggregate_energy", "gate_target", "calc_word_lengths",
           "apply_fade_inside_pauses", "calc_invert_durations", "transcription_by_frames"]


@handler(inputs={"phonemes"}, outputs={"phonemes"}, optional={"word_timestamps"})
def add_pauses_from_text(ds: TTSDataSample, level: str = "words",
                         begin_end_pauses: bool = True) -> TTSDataSample:
    """SIL tokens from the text: after every word (``level="words"``) or after
    each word whose text ends in punctuation (``"punctuation"``), and at both
    ends; repeated SILs collapse to one. The phonemes are grouped into words by
    the word timestamps (a phoneme's midpoint), else by ``word_lengths``, else one
    a word. The phoneme timestamps no longer fit and are dropped."""
    if ds.phonemes is None:
        return ds
    groups: tp.List[tp.List[str]] = []
    if ds.word_timestamps is not None and ds.phoneme_timestamps is not None:
        wts = np.asarray(ds.word_timestamps.intervals, np.float64)
        cur = -2
        for (b, e), lab in zip(ds.phoneme_timestamps, ds.phonemes):
            mid = 0.5 * (b + e)
            hits = np.nonzero((wts[:, 0] - 1e-6 <= mid) & (mid <= wts[:, 1] + 1e-6))[0]
            w = int(hits[0]) if len(hits) else -1
            if w != cur or not groups:
                groups.append([])
                cur = w
            groups[-1].append(lab)
    elif ds.word_lengths is not None:
        pos = 0
        for n in ds.word_lengths:
            groups.append(list(ds.phonemes[pos:pos + int(n)]))
            pos += int(n)
    else:
        groups = [[p] for p in ds.phonemes]

    words = ds.text.split() if ds.text else [""] * len(groups)
    out: tp.List[str] = [SIL] if begin_end_pauses else []
    wi = 0
    for g in groups:
        is_word = any(p not in (SIL, "", None) for p in g)
        out.extend(p if p not in ("", None) else SIL for p in g)
        if is_word:
            word = words[wi] if wi < len(words) else ""
            wi += 1
            trailing_punct = word and not word[-1].isalnum()
            if (level == "words" or trailing_punct) and (out and out[-1] != SIL):
                out.append(SIL)
    if begin_end_pauses and out and out[-1] != SIL:
        out.append(SIL)
    collapsed: tp.List[str] = []
    for p in out:
        if not (p == SIL and collapsed and collapsed[-1] == SIL):
            collapsed.append(p)
    ds.phonemes = collapsed
    ds.phoneme_timestamps = None
    return ds


@handler(inputs={"phonemes", "phoneme_timestamps"},
         outputs={"phonemes", "phoneme_timestamps"})
def add_pauses_from_timestamps(ds: TTSDataSample, min_len: float = 0.03,
                               merge_short: bool = True) -> TTSDataSample:
    """Empty-label intervals (gaps) become SIL tokens; with ``merge_short`` a
    gap shorter than ``min_len`` is merged into the token before it. A sample
    without timestamps (raw text) is left as it is."""
    if ds.phoneme_timestamps is None:
        return ds
    phs, ts = [], []
    for label, (b, e) in zip(ds.phonemes, ds.phoneme_timestamps):
        if label in ("", SIL, "undefined_sil", None):
            if e - b >= min_len or not ts or not merge_short:
                phs.append(SIL)
                ts.append([b, e])
            else:
                ts[-1][1] = e  # absorbed by the previous token
        else:
            phs.append(label)
            ts.append([b, e])
    ds.phonemes = phs
    ds.phoneme_timestamps = Timestamps(np.asarray(ts))
    return ds


@handler(inputs={"transcription", "phoneme_timestamps"}, outputs={"durations"})
def calc_durations(ds: TTSDataSample) -> TTSDataSample:
    """Frames per token of the transcription, summing exactly to the mel's
    length; with service tokens, BOS spans [0, first phoneme) and EOS [last
    phoneme, audio end)."""
    hop = ds.get_param_val("hop_len", ds.hop_len or 256)
    sr = ds.audio_chunk.sr if ds.audio_chunk is not None else ds.get_param_val("sample_rate")
    ts = ds.phoneme_timestamps
    if ds.n_tokens == len(ts) + 2:
        total = ds.audio_chunk.duration if ds.audio_chunk is not None else ts.end
        ts = Timestamps(np.concatenate([np.asarray([[0.0, ts.begin]]), ts.intervals,
                                        np.asarray([[ts.end, max(total, ts.end)]])], axis=0))
    ds.durations = ts.to_frames(hop, int(sr), n_frames=ds.n_frames or None).astype(np.float32)
    if len(ds.durations) != ds.n_tokens:
        raise ValueError(f"{len(ds.durations)} durations for {ds.n_tokens} tokens")
    return ds


_REDUCE = {"mean": np.mean, "median": np.median, "min": np.min, "max": np.max,
           "range": np.ptp}


def _aggregate(feat: np.ndarray, durations: np.ndarray, mode: str = "mean",
               voiced_only: bool = False) -> np.ndarray:
    """Frame-level ``feat`` (T,) reduced over each token's frames (N,); a
    token without frames (or without voiced frames) gets 0."""
    edges = np.concatenate([[0], np.cumsum(durations.astype(np.int64))])
    out = np.zeros(len(durations), dtype=np.float32)
    for i in range(len(durations)):
        seg = feat[edges[i]:edges[i + 1]]
        if voiced_only:
            seg = seg[seg > 0]
        out[i] = _REDUCE[mode](seg) if len(seg) else 0.0
    return out


@handler(inputs={"durations", "pitch"}, outputs={"aggregate_pitch"})
def aggregate_pitch(ds: TTSDataSample, mode: str = "mean",
                    voiced_only: bool = True) -> TTSDataSample:
    """Token-level pitch; with ``voiced_only`` the mean of each token's voiced
    frames, whatever ``mode`` says (as the JAX handler)."""
    ds.aggregate_pitch = _aggregate(ds.pitch, ds.durations,
                                    "mean" if voiced_only else mode, voiced_only)
    return ds


@handler(inputs={"durations", "energy"}, outputs={"aggregate_energy"})
def aggregate_energy(ds: TTSDataSample, mode: str = "mean") -> TTSDataSample:
    ds.aggregate_energy = _aggregate(ds.energy, ds.durations, mode)
    return ds


@handler(inputs={"mel"}, outputs={"gate"})
def gate_target(ds: TTSDataSample, last_frames: int = 1) -> TTSDataSample:
    """1 on the last ``last_frames`` frames, 0 before."""
    t = ds.n_frames
    gate = np.zeros(t, dtype=np.float32)
    gate[max(0, t - last_frames):] = 1.0
    ds.gate = gate
    return ds


@handler(inputs={"transcription"}, outputs={"word_lengths"})
def calc_word_lengths(ds: TTSDataSample) -> TTSDataSample:
    """Per word, the phonemes whose interval lies inside it (1e-6 s slack);
    without timestamps one word of every token."""
    if ds.word_timestamps is None or ds.phoneme_timestamps is None:
        ds.word_lengths = np.asarray([ds.n_tokens], dtype=np.int32)
        return ds
    counts = [sum(1 for b, e in ds.phoneme_timestamps if b >= wb - 1e-6 and e <= we + 1e-6)
              for wb, we in ds.word_timestamps]
    ds.word_lengths = np.asarray(counts, dtype=np.int32)
    return ds


@handler(inputs={"audio_chunk", "phonemes", "phoneme_timestamps"}, outputs={"audio_chunk"})
def apply_fade_inside_pauses(ds: TTSDataSample) -> TTSDataSample:
    """Fade the waveform to silence inside each SIL interval: a steep
    log-space curve out over its first half and in over its second; a side
    next to another pause or the utterance's edge stays silent."""
    if ds.phoneme_timestamps is None or ds.audio_chunk is None:
        return ds
    sr = ds.audio_chunk.sr
    wav = np.array(ds.audio_chunk.waveform)
    phonemes = list(ds.phonemes)
    for idx, (ph, (b, e)) in enumerate(zip(phonemes, ds.phoneme_timestamps)):
        if ph != SIL:
            continue
        a, z = max(int(b * sr), 0), min(int(e * sr), len(wav))
        if z - a <= 1:
            continue
        l_len = (z - a) // 2
        r_len = (z - a) - l_len
        l_curve = np.flip(np.logspace(-1.0, 1.0, l_len) ** 4.0 / 10000.0)
        if idx == 0 or phonemes[idx - 1] == SIL:
            l_curve = l_curve * 0.0
        r_curve = np.logspace(-1.0, 1.0, r_len) ** 4.0 / 10000.0
        if idx == len(phonemes) - 1 or (idx + 1 < len(phonemes) and phonemes[idx + 1] == SIL):
            r_curve = r_curve * 0.0
        wav[a:z] = wav[a:z] * np.concatenate([l_curve, r_curve]).astype(np.float32)
    ds.audio_chunk.data = wav.astype(np.float32)
    return ds


@handler(inputs={"durations"}, outputs={"invert_durations"})
def calc_invert_durations(ds: TTSDataSample) -> TTSDataSample:
    """``additional["invert_durations"]``: each frame carries 1 / its token's
    frames."""
    if ds.durations is None:
        return ds
    durs = np.asarray(ds.durations).astype(np.int64)
    ds.additional["invert_durations"] = np.repeat(
        np.where(durs > 0, 1.0 / np.maximum(durs, 1), 0.0), np.maximum(durs, 0)
    ).astype(np.float32)
    return ds


@handler(inputs={"durations", "transcription"}, outputs={"transcription_by_frames"})
def transcription_by_frames(ds: TTSDataSample) -> TTSDataSample:
    """``additional["transcription_by_frames"]``: each token id repeated by its
    frames (a CTC target at frame level); as long as the mel."""
    if ds.durations is None or ds.transcription is None:
        return ds
    durs = np.asarray(ds.durations).astype(np.int64)
    ext = np.repeat(np.asarray(ds.transcription), np.maximum(durs, 0))
    if ds.mel is not None and len(ext) != ds.mel.shape[0]:
        raise ValueError(f"{len(ext)} frames of transcription for {ds.mel.shape[0]} of mel")
    ds.additional["transcription_by_frames"] = ext.astype(np.int32)
    return ds
