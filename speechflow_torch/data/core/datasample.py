"""Sample records (counterpart of ``speechflow_tpu/data/core/datasample.py``):
``DataSample``, the plain record of ``SimpleDSParser`` and ``EasyDSParser``
and the base of the others (its fields by name, ``get``, ``setdefaults``,
``get_param_val``, ``serialize``), and ``ImageDataSample``, which adds an image (the MNIST example's);
``AudioDataSample``, what the audio handlers read and write (the vocoder's
training data); ``SpectrogramDataSample``, which adds the spectral handlers'
fields; and ``TTSDataSample``, which adds what ``TTSDSParser`` reads from a
TextGrid (phonemes, timestamps, the word tiers) and the token- and
frame-level targets the acoustic model trains on. A raw-text request fills
only its text fields. Samples hold numpy on the host; the batch processors
make tensors of the collated batch.

``len(sample)`` is 1, as in the JAX package: a sampler with ``comb_by_len``
sorts by it, so the sort keeps the file order.
"""

from __future__ import annotations

import copy
import hashlib
import typing as tp
from dataclasses import dataclass, field, fields

import numpy as np

from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.io.serialize import Serialize
from speechflow_torch.io.timestamps import Timestamps

__all__ = ["DataSample", "ImageDataSample", "AudioDataSample", "SpectrogramDataSample",
           "TTSDataSample", "ProsodyPredictionDataSample"]

Array = tp.Optional[np.ndarray]
Labels = tp.Optional[tp.List[str]]


def _uid(file_path, label, index) -> str:
    """The JAX sample's id: sha256 of ``file_path|label|index``, 16 hex digits."""
    return hashlib.sha256(f"{file_path or ''}|{label or ''}|{index}".encode()).hexdigest()[:16]


@dataclass
class DataSample:
    file_path: tp.Optional[str] = None
    label: tp.Optional[str] = None
    tag: tp.Optional[str] = None
    index: int = 0
    transform_params: tp.Dict[str, dict] = field(default_factory=dict)
    additional: tp.Dict[str, tp.Any] = field(default_factory=dict)

    def copy(self):
        """A deep copy: the handlers change a sample in place."""
        return copy.deepcopy(self)

    @property
    def uid(self) -> str:
        return _uid(self.file_path, self.label, self.index)

    def field_names(self) -> tp.List[str]:
        return [f.name for f in fields(self)]

    def get(self, name: str, default=None):
        """A field, else an entry of ``additional``."""
        if hasattr(self, name):
            return getattr(self, name)
        return self.additional.get(name, default)

    def setdefaults(self, **kwargs) -> "DataSample":
        """Set each given field that is None now."""
        for k, v in kwargs.items():
            if getattr(self, k, None) is None:
                setattr(self, k, v)
        return self

    def get_param_val(self, name: str, default=None):
        """A parameter an earlier handler recorded in ``transform_params``."""
        for params in self.transform_params.values():
            if name in params:
                return params[name]
        return default

    def serialize(self) -> bytes:
        return Serialize.dump(self)

    @staticmethod
    def deserialize(blob: bytes) -> "DataSample":
        return Serialize.load(blob)

    def __len__(self) -> int:
        return 1


@dataclass
class ImageDataSample(DataSample):
    image: Array = None                 # (H, W, C)


@dataclass
class AudioDataSample(DataSample):
    audio_chunk: tp.Optional[AudioChunk] = None
    sample_rate: tp.Optional[int] = None
    speaker_name: tp.Optional[str] = None
    speaker_id: tp.Optional[int] = None
    lang: tp.Optional[str] = None
    lang_id: tp.Optional[int] = None
    speaker_emb: Array = None
    speech_quality_emb: Array = None    # (5,) speech-quality statistics
    ssl_feat: Array = None              # (T', D) SSL features
    ac_feat: Array = None               # (T', D) neural-codec features
    mu_law_waveform: Array = None       # (S,) mu-law companded waveform

    @property
    def waveform(self) -> Array:
        return None if self.audio_chunk is None else self.audio_chunk.data


@dataclass
class SpectrogramDataSample(AudioDataSample):
    magnitude: Array = None             # (T, n_fft // 2 + 1)
    mel: Array = None                   # (T, n_mels)
    energy: Array = None                # (T,)
    pitch: Array = None                 # (T,)
    spectral_flatness: Array = None     # (T,)
    hop_len: tp.Optional[int] = None
    #: per-utterance scalars of ``average_by_time``, by contour
    averages: tp.Optional[tp.Dict[str, np.ndarray]] = None
    #: (lo, hi, span) of each contour ``normalize`` scaled
    ranges: tp.Optional[tp.Dict[str, np.ndarray]] = None

    @property
    def n_frames(self) -> int:
        for feat in (self.mel, self.magnitude, self.energy, self.pitch):
            if feat is not None:
                return feat.shape[0]
        return 0


@dataclass
class TTSDataSample(SpectrogramDataSample):
    sega_path: tp.Optional[str] = None
    text: tp.Optional[str] = None
    phonemes: Labels = None
    transcription: Array = None         # (N,) token ids
    phoneme_timestamps: tp.Optional[Timestamps] = None
    word_timestamps: tp.Optional[Timestamps] = None
    durations: Array = None             # (N,) frames per token
    gate: Array = None                  # (T,) stop target
    aggregate_pitch: Array = None       # (N,)
    aggregate_energy: Array = None      # (N,)
    ling_feat: Array = None             # (N, F) linguistic features
    lm_feat: Array = None               # (N, D) word-level LM embeddings
    xpbert_feat: Array = None           # (N, D) phoneme-level LM embeddings
    word_lengths: Array = None          # tokens per word
    prosody: Array = None               # (N,) prosody class per token
    intonation_type: tp.Optional[str] = None
    # word-level parser tiers of a TextGridStage3 file (add_ling_feat reads them)
    pos_tags: Labels = None
    syntax_rels: Labels = None
    word_ids: Labels = None
    head_ids: Labels = None
    emphasis_labels: Labels = None
    prosody_labels: Labels = None
    syntagma_ids: tp.Optional[tp.List[int]] = None

    @property
    def n_tokens(self) -> int:
        return 0 if self.transcription is None else len(self.transcription)


@dataclass
class ProsodyPredictionDataSample(DataSample):
    """A word-level prosody sample: the words, their token ids and per-word
    targets (binary has-contour and the contour class; -1 is left out of the
    loss)."""

    words: Labels = None
    token_ids: Array = None             # (N,)
    binary: Array = None                # (N,) 0/1, -1 pad
    category: Array = None              # (N,) contour class, -1 pad
