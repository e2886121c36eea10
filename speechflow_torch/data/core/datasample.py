"""Sample records (counterpart of ``speechflow_tpu/data/core/datasample.py``):
``AudioDataSample``, what the audio handlers read and write (the vocoder's
training data), and ``TTSDataSample``, the fields a raw-text request fills
and the collate reads. Samples hold numpy on the host; the batch processors
make tensors of the collated batch. The spectral and parser-tier fields of
the JAX classes wait for the TTS data path."""

from __future__ import annotations

import copy
import typing as tp
from dataclasses import dataclass, field

import numpy as np

from speechflow_torch.io.audio import AudioChunk

__all__ = ["AudioDataSample", "TTSDataSample"]

Array = tp.Optional[np.ndarray]


@dataclass
class AudioDataSample:
    file_path: tp.Optional[str] = None
    label: tp.Optional[str] = None
    index: int = 0
    audio_chunk: tp.Optional[AudioChunk] = None
    sample_rate: tp.Optional[int] = None
    speaker_name: tp.Optional[str] = None
    speaker_id: tp.Optional[int] = None
    lang: tp.Optional[str] = None
    lang_id: tp.Optional[int] = None
    speaker_emb: Array = None
    #: each handler's parameters, by handler
    transform_params: tp.Dict[str, dict] = field(default_factory=dict)
    additional: tp.Dict[str, tp.Any] = field(default_factory=dict)

    def copy(self) -> "AudioDataSample":
        """A deep copy: the handlers change a sample in place."""
        return copy.deepcopy(self)

    def __len__(self) -> int:
        return 1


@dataclass
class TTSDataSample:
    text: tp.Optional[str] = None
    lang: tp.Optional[str] = None
    speaker_name: tp.Optional[str] = None
    speaker_id: tp.Optional[int] = None
    lang_id: tp.Optional[int] = None
    speaker_emb: Array = None
    phonemes: tp.Optional[tp.List[str]] = None
    transcription: Array = None         # (N,) token ids
    durations: Array = None             # (N,) frames per token
    aggregate_pitch: Array = None       # (N,)
    aggregate_energy: Array = None      # (N,)
    ling_feat: Array = None             # (N, F) linguistic features
    lm_feat: Array = None               # (N, D) word-level LM embeddings
    xpbert_feat: Array = None           # (N, D) phoneme-level LM embeddings
    word_lengths: Array = None          # tokens per word
    prosody: Array = None               # (N,) prosody class per token
    #: each handler's parameters, by handler
    transform_params: tp.Dict[str, dict] = field(default_factory=dict)
    #: fields without a slot of their own (SSML words and modifiers)
    additional: tp.Dict[str, tp.Any] = field(default_factory=dict)

    @property
    def n_tokens(self) -> int:
        return 0 if self.transcription is None else len(self.transcription)
