"""Dataset-level handlers fitted once on the training subset (counterpart of
``SpeakerIDSetter`` and ``DatasetStatistics`` in
``speechflow_tpu/data/processors/singletons.py``, the two the vocoder's data
config lists). Their ``state_dict`` goes into the pipeline info a checkpoint
carries."""

from __future__ import annotations

import typing as tp

__all__ = ["SpeakerIDSetter", "DatasetStatistics", "SINGLETON_HANDLERS"]


class SpeakerIDSetter:
    """Speaker and language ids in sorted name order; ``apply`` sets a sample's."""

    def __init__(self, min_samples: int = 0):
        self.speaker2id: tp.Dict[str, int] = {}
        self.lang2id: tp.Dict[str, int] = {}
        self.min_samples = min_samples

    def fit(self, dataset: tp.Iterable) -> "SpeakerIDSetter":
        counts: tp.Dict[str, int] = {}
        langs: tp.Set[str] = set()
        for ds in dataset:
            if getattr(ds, "speaker_name", None):
                counts[ds.speaker_name] = counts.get(ds.speaker_name, 0) + 1
            if getattr(ds, "lang", None):
                langs.add(ds.lang)
        for name in sorted(counts):
            if counts[name] >= self.min_samples and name not in self.speaker2id:
                self.speaker2id[name] = len(self.speaker2id)
        for lang in sorted(langs):
            self.lang2id.setdefault(lang, len(self.lang2id))
        return self

    def apply(self, ds):
        if getattr(ds, "speaker_name", None) is not None:
            ds.speaker_id = self.speaker2id.get(ds.speaker_name)
        if getattr(ds, "lang", None) is not None:
            ds.lang_id = self.lang2id.get(ds.lang)
        return ds

    def state_dict(self) -> dict:
        return {"speaker2id": dict(self.speaker2id), "lang2id": dict(self.lang2id)}


class DatasetStatistics:
    """Sample count, durations (total, longest, per speaker) and lengths."""

    def __init__(self):
        self.max_transcription_length = 0
        self.max_frames = 0
        self.max_audio_duration = 0.0
        self.total_duration = 0.0
        self.n_samples = 0
        self.speaker_durations: tp.Dict[str, float] = {}

    def fit(self, dataset: tp.Iterable) -> "DatasetStatistics":
        for ds in dataset:
            self.n_samples += 1
            tr = getattr(ds, "transcription", None)
            if tr is not None:
                self.max_transcription_length = max(self.max_transcription_length, len(tr))
            self.max_frames = max(self.max_frames, getattr(ds, "n_frames", 0) or 0)
            ac = getattr(ds, "audio_chunk", None)
            if ac is not None:
                dur = ac.duration
                self.max_audio_duration = max(self.max_audio_duration, dur)
                self.total_duration += dur
                spk = getattr(ds, "speaker_name", None) or "__all__"
                self.speaker_durations[spk] = self.speaker_durations.get(spk, 0.0) + dur
        return self

    def state_dict(self) -> dict:
        return dict(self.__dict__)


SINGLETON_HANDLERS = {"SpeakerIDSetter": SpeakerIDSetter,
                      "DatasetStatistics": DatasetStatistics}
