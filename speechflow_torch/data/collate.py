"""Collation (counterpart of ``speechflow_tpu/data/collate.py``):
``AudioCollate`` (waveforms padded to a multiple of ``sample_multiple``, ids,
speaker embeddings), ``SpectrogramCollate`` (also the frame-level fields: mel,
magnitude, energy, pitch, and the per-utterance ``averages`` (name -> (B,), 0
where a sample lacks one); the NSF vocoder's data) and ``TTSCollate``.

``TTSCollate`` pads tokens to a multiple of ``token_multiple``, token-level
features (durations, aggregate pitch and energy, ling/LM/XPBERT features)
to the same length with 0, prosody classes with -1 (undefined), and the
SSML modifiers of ``ds.additional`` with 1.0; where only some samples carry
a modifier, the others get 1.0 on every token (the JAX collate drops the
modifier for the whole batch then). The frame-level fields (mel, magnitude,
pitch, energy) are padded to a multiple of ``frame_multiple``, the gate to
the mel's frames with 1 from each sample's last frame on, and loaded
waveforms to a multiple of ``sample_multiple``. A raw-text batch has only
the token-level fields.

``TTSCollateWithPrompt`` (the XTTS recipes' collate) also pairs each row with
a prompt row of the same speaker from the batch (``additional``'s
``prompt_index``, ``prompt_mel``, ``prompt_mel_lengths`` and
``prompt_transcription``).

``ImageCollate`` stacks images as float32 with each label's id (a label not in
``label2id`` gets the next id); ``NoCollate`` (registered as ``none``, a data
config's default) gives None for any batch.
"""

from __future__ import annotations

import typing as tp
from dataclasses import dataclass, field

import numpy as np

from speechflow_torch.data.core.datasample import (
    AudioDataSample,
    ImageDataSample,
    SpectrogramDataSample,
    TTSDataSample,
)
from speechflow_torch.utils.pad import stack_and_pad

__all__ = ["CollatedAudio", "AudioCollate", "CollatedSpectrogram", "SpectrogramCollate",
           "CollatedTTS", "TTSCollate", "TTSCollateWithPrompt", "CollatedImage", "ImageCollate",
           "NoCollate", "COLLATES"]

Array = tp.Optional[np.ndarray]
TOKEN_FIELDS = ("durations", "aggregate_pitch", "aggregate_energy", "ling_feat", "lm_feat",
                "xpbert_feat")
MODIFIER_KEYS = ("pitch_modifier", "volume_modifier", "rate_modifier")


@dataclass
class CollatedAudio:
    waveform: Array = None                 # (B, T) float32
    waveform_lengths: Array = None         # (B,)
    speaker_id: Array = None
    lang_id: Array = None
    speaker_emb: Array = None
    additional: tp.Dict[str, np.ndarray] = field(default_factory=dict)


@dataclass
class CollatedSpectrogram:
    speaker_id: Array = None               # (B,)
    lang_id: Array = None
    speaker_emb: Array = None              # (B, D)
    waveform: Array = None                 # (B, S) float32
    waveform_lengths: Array = None
    mel: Array = None                      # (B, T, n_mels)
    mel_lengths: Array = None
    magnitude: Array = None                # (B, T, n_fft // 2 + 1)
    energy: Array = None                   # (B, T)
    pitch: Array = None
    averages: tp.Optional[tp.Dict[str, np.ndarray]] = None  # name -> (B,)


@dataclass
class CollatedTTS:
    speaker_id: Array = None               # (B,)
    lang_id: Array = None
    speaker_emb: Array = None              # (B, D)
    waveform: Array = None                 # (B, S) float32
    waveform_lengths: Array = None
    mel: Array = None                      # (B, T, n_mels)
    mel_lengths: Array = None
    magnitude: Array = None                # (B, T, n_fft // 2 + 1)
    energy: Array = None                   # (B, T)
    pitch: Array = None
    averages: tp.Optional[tp.Dict[str, np.ndarray]] = None  # name -> (B,)
    gate: Array = None                     # (B, T)
    transcription: Array = None            # (B, N)
    transcription_lengths: Array = None
    durations: Array = None
    aggregate_pitch: Array = None
    aggregate_energy: Array = None
    ling_feat: Array = None
    lm_feat: Array = None
    xpbert_feat: Array = None
    prosody: Array = None
    additional: tp.Dict[str, np.ndarray] = field(default_factory=dict)


def _ids(samples, attr: str) -> np.ndarray:
    return np.asarray([-1 if getattr(s, attr) is None else getattr(s, attr) for s in samples],
                      dtype=np.int32)


class AudioCollate:
    def __init__(self, sample_multiple: int = 256):
        self.sample_multiple = sample_multiple

    def __call__(self, samples: tp.List[AudioDataSample]) -> CollatedAudio:
        waveform, lens = stack_and_pad([s.audio_chunk.waveform for s in samples],
                                       multiple=self.sample_multiple)
        out = CollatedAudio(waveform=waveform.astype(np.float32), waveform_lengths=lens,
                            speaker_id=_ids(samples, "speaker_id"),
                            lang_id=_ids(samples, "lang_id"))
        embs = [s.speaker_emb for s in samples]
        if all(e is not None for e in embs):
            out.speaker_emb = np.stack(embs).astype(np.float32)
        return out


class SpectrogramCollate:
    def __init__(self, frame_multiple: int = 64, sample_multiple: int = 256):
        self.frame_multiple = frame_multiple
        self.sample_multiple = sample_multiple

    def _frames(self, samples, out) -> None:
        """The ids, speaker embeddings, and the sample- and frame-level fields."""
        embs = [s.speaker_emb for s in samples]
        if all(e is not None for e in embs):
            out.speaker_emb = np.stack(embs).astype(np.float32)
        if samples[0].audio_chunk is not None and samples[0].audio_chunk.data is not None:
            out.waveform, out.waveform_lengths = stack_and_pad(
                [s.audio_chunk.waveform for s in samples], multiple=self.sample_multiple)
        t_mel = None
        if samples[0].mel is not None:
            out.mel, out.mel_lengths = stack_and_pad([s.mel for s in samples],
                                                     multiple=self.frame_multiple)
            t_mel = out.mel.shape[1]
        for attr in ("magnitude", "energy", "pitch"):
            values = [getattr(s, attr) for s in samples]
            if all(v is not None for v in values):
                setattr(out, attr, stack_and_pad(values, multiple=self.frame_multiple,
                                                 target_len=t_mel)[0])
        avgs = [getattr(s, "averages", None) for s in samples]
        if all(a is not None for a in avgs):
            keys = sorted(set().union(*[a.keys() for a in avgs]))
            out.averages = {k: np.asarray([a.get(k, 0.0) for a in avgs], np.float32)
                            for k in keys}

    def __call__(self, samples: tp.List[SpectrogramDataSample]) -> CollatedSpectrogram:
        out = CollatedSpectrogram(speaker_id=_ids(samples, "speaker_id"),
                                  lang_id=_ids(samples, "lang_id"))
        self._frames(samples, out)
        return out


class TTSCollate(SpectrogramCollate):
    def __init__(self, token_multiple: int = 16, frame_multiple: int = 64,
                 sample_multiple: int = 256):
        super().__init__(frame_multiple, sample_multiple)
        self.token_multiple = token_multiple

    def _frames(self, samples: tp.List[TTSDataSample], out: CollatedTTS) -> None:
        """``SpectrogramCollate``'s fields and the stop-gate target."""
        super()._frames(samples, out)
        gates = [s.gate for s in samples]
        if out.mel is not None and all(g is not None for g in gates):
            # padding frames keep gate 1, so the stop head trains on them too
            t_mel = out.mel.shape[1]
            gate = stack_and_pad(gates, target_len=t_mel)[0]
            pos = np.arange(t_mel)[None, :]
            out.gate = np.where(pos >= out.mel_lengths[:, None] - 1, 1.0, gate)

    def __call__(self, samples: tp.List[TTSDataSample]) -> CollatedTTS:
        out = CollatedTTS(speaker_id=_ids(samples, "speaker_id"),
                          lang_id=_ids(samples, "lang_id"))
        self._frames(samples, out)
        out.transcription, out.transcription_lengths = stack_and_pad(
            [s.transcription for s in samples], multiple=self.token_multiple)
        out.transcription = out.transcription.astype(np.int32)
        n_tok = out.transcription.shape[1]

        def stacked(values, pad_value=0.0):
            if any(v is None for v in values):
                return None
            return stack_and_pad(values, pad_value=pad_value, target_len=n_tok)[0]

        for attr in TOKEN_FIELDS:
            setattr(out, attr, stacked([getattr(s, attr) for s in samples]))
        pros = stacked([s.prosody for s in samples], pad_value=-1)
        out.prosody = None if pros is None else pros.astype(np.int32)
        for key in MODIFIER_KEYS:
            mods = [s.additional.get(key) for s in samples]
            if all(m is None for m in mods):
                continue
            # a plain sample in a batch with SSML ones keeps its neutral 1.0
            mods = [np.ones(len(s.transcription), np.float32) if m is None else m
                    for m, s in zip(mods, samples)]
            out.additional[key] = stacked(mods, pad_value=1.0)
        return out


class TTSCollateWithPrompt(TTSCollate):
    """``TTSCollate`` with a prompt for each row: the first other row of the batch
    with the same ``speaker_id``, else the row itself."""

    def __call__(self, samples: tp.List[TTSDataSample]) -> CollatedTTS:
        out = super().__call__(samples)
        spk = [getattr(s, "speaker_id", None) for s in samples]
        idx = np.asarray([next((j for j, sj in enumerate(spk) if sj == sid and j != i), i)
                          for i, sid in enumerate(spk)], np.int64)
        out.additional["prompt_index"] = idx.astype(np.int32)
        if out.mel is not None:
            out.additional["prompt_mel"] = out.mel[idx]
            out.additional["prompt_mel_lengths"] = out.mel_lengths[idx]
        out.additional["prompt_transcription"] = out.transcription[idx]
        return out


@dataclass
class CollatedImage:
    image: Array = None                    # (B, H, W, C) float32
    label_id: Array = None                 # (B,) int32


class ImageCollate:
    def __init__(self, label2id: tp.Optional[tp.Dict[str, int]] = None):
        self.label2id = label2id or {}

    def __call__(self, samples: tp.List[ImageDataSample]) -> CollatedImage:
        for s in samples:
            self.label2id.setdefault(s.label, len(self.label2id))
        return CollatedImage(
            image=np.stack([s.image for s in samples]).astype(np.float32),
            label_id=np.asarray([self.label2id[s.label] for s in samples], np.int32))


class NoCollate:
    def __call__(self, samples) -> None:
        return None


COLLATES = {"AudioCollate": AudioCollate, "SpectrogramCollate": SpectrogramCollate,
            "TTSCollate": TTSCollate, "TTSCollateWithPrompt": TTSCollateWithPrompt,
            "ImageCollate": ImageCollate, "none": NoCollate}
