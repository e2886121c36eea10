"""Dataset-level handlers fitted once on the training subset (counterpart of
``SpeakerIDSetter``, ``StatisticsRange``, ``DatasetStatistics`` and
``PhonemeStatistics`` and ``MeanBioEmbeddings`` in
``speechflow_tpu/data/processors/singletons.py``: the ones the vocoder's and
the TTS data configs list, and the per-speaker mean speaker embedding the TTS
interface serves as its catalog). Their ``state_dict``
goes into the pipeline info a checkpoint carries, and ``load_state_dict``
seeds a handler from one before it is fitted (a resumed, fine-tuned or
warm-started run keeps its checkpoint's speaker and language ids);
``PhonemeStatistics``' symbols make the training pipeline's alphabet."""

from __future__ import annotations

import json
import typing as tp
from pathlib import Path

import numpy as np

__all__ = ["BaseSingleton", "SpeakerIDSetter", "StatisticsRange", "DatasetStatistics", "PhonemeStatistics",
           "MeanBioEmbeddings", "SINGLETON_HANDLERS"]


class BaseSingleton:
    """A handler fitted once over a dataset (``fit``), applied to each sample
    (``apply``, by default the sample as it is), carried as a state dict and
    merged across corpora (``aggregate``, by default this one). A plain object
    the pipeline owns: the JAX package makes it one instance per process and
    thread (``data/core/singleton.py::Singleton`` here, for code that wants it)."""

    def fit(self, dataset: tp.Iterable) -> "BaseSingleton":
        raise NotImplementedError

    def apply(self, ds):
        return ds

    def state_dict(self) -> dict:
        raise NotImplementedError

    def load_state_dict(self, d: dict) -> None:
        raise NotImplementedError

    def aggregate(self, other: "BaseSingleton") -> "BaseSingleton":
        return self


class SpeakerIDSetter(BaseSingleton):
    """Speaker and language ids in sorted name order; ``apply`` sets a sample's.
    ``resume_from``: a state dict to start from (a checkpoint's ids stay)."""

    def __init__(self, resume_from: tp.Optional[dict] = None, min_samples: int = 0):
        self.speaker2id: tp.Dict[str, int] = {}
        self.lang2id: tp.Dict[str, int] = {}
        self.min_samples = min_samples
        if resume_from:
            self.load_state_dict(resume_from)

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

    @property
    def n_speakers(self) -> int:
        return len(self.speaker2id)

    @property
    def n_langs(self) -> int:
        return len(self.lang2id)

    def state_dict(self) -> dict:
        return {"speaker2id": dict(self.speaker2id), "lang2id": dict(self.lang2id)}

    def load_state_dict(self, d: dict) -> None:
        self.speaker2id = dict(d["speaker2id"])
        self.lang2id = dict(d["lang2id"])

    def aggregate(self, other: "SpeakerIDSetter") -> "SpeakerIDSetter":
        """Append ``other``'s new speakers and languages (sorted) after these."""
        for name in sorted(other.speaker2id):
            self.speaker2id.setdefault(name, len(self.speaker2id))
        for lang in sorted(other.lang2id):
            self.lang2id.setdefault(lang, len(self.lang2id))
        return self


class StatisticsRange(BaseSingleton):
    """Per speaker, per feature (pitch, energy and their token aggregates):
    the 1% and 99% quantiles, mean and std of the values (pitch's voiced
    ones). Fitted at parse time, before any handler ran, it usually sees no
    feature and stays empty, as in the JAX package; a ``ranges_file`` (the
    ``ranges.json`` a dump writes) is loaded instead when it exists."""

    FEATURES = ("pitch", "energy", "aggregate_pitch", "aggregate_energy")

    def __init__(self, ranges_file: tp.Optional[str] = None):
        self.ranges: tp.Dict[str, tp.Dict[str, tp.Tuple[float, float, float, float]]] = {}
        if ranges_file and Path(ranges_file).exists():
            self.ranges = json.loads(Path(ranges_file).read_text())

    def fit(self, dataset: tp.Iterable) -> "StatisticsRange":
        if self.ranges:
            return self
        acc: tp.Dict[tp.Tuple[str, str], tp.List[np.ndarray]] = {}
        for ds in dataset:
            spk = getattr(ds, "speaker_name", None) or "__all__"
            for feat in self.FEATURES:
                val = getattr(ds, feat, None)
                if val is not None:
                    v = np.asarray(val).ravel()
                    v = v[v != 0] if "pitch" in feat else v
                    if len(v):
                        acc.setdefault((spk, feat), []).append(v)
        for (spk, feat), chunks in acc.items():
            v = np.concatenate(chunks)
            self.ranges.setdefault(spk, {})[feat] = (
                float(np.quantile(v, 0.01)), float(np.quantile(v, 0.99)),
                float(v.mean()), float(v.std()))
        return self

    def get(self, feature: str, speaker: tp.Optional[str] = None
            ) -> tp.Tuple[float, float, float, float]:
        """(lo, hi, mean, std) of ``feature`` for ``speaker`` (else ``__all__``,
        else the first speaker's); (0, 1, 0, 1) where there is none."""
        spk = speaker if speaker in self.ranges else "__all__"
        if spk not in self.ranges and self.ranges:
            spk = next(iter(self.ranges))
        return self.ranges.get(spk, {}).get(feature) or (0.0, 1.0, 0.0, 1.0)

    def as_arrays(self, feature: str, speaker2id: tp.Dict[str, int]) -> np.ndarray:
        """(n_speakers, 4) float32 table of ``get(feature, name)`` by speaker id
        (one row of defaults where there is no speaker)."""
        out = np.zeros((max(len(speaker2id), 1), 4), dtype=np.float32)
        for name, sid in speaker2id.items():
            out[sid] = self.get(feature, name)
        return out

    def state_dict(self) -> dict:
        return {"ranges": self.ranges}

    def load_state_dict(self, d: dict) -> None:
        self.ranges = d["ranges"]

    def aggregate(self, other: "StatisticsRange") -> "StatisticsRange":
        for spk, feats in other.ranges.items():
            self.ranges.setdefault(spk, {}).update(feats)
        return self


class DatasetStatistics(BaseSingleton):
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

    def load_state_dict(self, d: dict) -> None:
        self.__dict__.update(d)

    def aggregate(self, other: "DatasetStatistics") -> "DatasetStatistics":
        self.max_transcription_length = max(self.max_transcription_length,
                                            other.max_transcription_length)
        self.max_frames = max(self.max_frames, other.max_frames)
        self.max_audio_duration = max(self.max_audio_duration, other.max_audio_duration)
        self.total_duration += other.total_duration
        self.n_samples += other.n_samples
        for k, v in other.speaker_durations.items():
            self.speaker_durations[k] = self.speaker_durations.get(k, 0.0) + v
        return self


class PhonemeStatistics(BaseSingleton):
    """How often each phoneme occurs (an empty label counts as ``<SIL>``)."""

    def __init__(self):
        self.counts: tp.Dict[str, int] = {}

    def fit(self, dataset: tp.Iterable) -> "PhonemeStatistics":
        for ds in dataset:
            phs = getattr(ds, "phonemes", None)
            if not phs and getattr(ds, "text", None):
                # a text-only corpus (the raw .TextGrid of stage 1): count what the
                # `phonemize` handler's default will emit, so the alphabet covers it
                from speechflow_torch.data.processors.text import phonemize_words

                phs, _ = phonemize_words(ds.text, lang=getattr(ds, "lang", None) or "EN")
            for p in phs or ():
                key = p if p else "<SIL>"
                self.counts[key] = self.counts.get(key, 0) + 1
        return self

    @property
    def symbols(self) -> tp.List[str]:
        return sorted(self.counts)

    def state_dict(self) -> dict:
        return {"counts": dict(self.counts)}

    def load_state_dict(self, d: dict) -> None:
        self.counts = dict(d["counts"])

    def aggregate(self, other: "PhonemeStatistics") -> "PhonemeStatistics":
        for k, v in other.counts.items():
            self.counts[k] = self.counts.get(k, 0) + v
        return self


class MeanBioEmbeddings(BaseSingleton):
    """Per-speaker mean of the samples' ``speaker_emb`` (samples without a
    speaker name pool under ``__all__``); ``apply`` gives a sample without an
    embedding its speaker's mean."""

    def __init__(self):
        self.mean_emb: tp.Dict[str, np.ndarray] = {}

    def fit(self, dataset: tp.Iterable) -> "MeanBioEmbeddings":
        acc: tp.Dict[str, list] = {}
        for ds in dataset:
            emb = getattr(ds, "speaker_emb", None)
            if emb is not None:
                acc.setdefault(ds.speaker_name or "__all__", []).append(np.asarray(emb))
        for spk, embs in acc.items():
            self.mean_emb[spk] = np.mean(np.stack(embs), axis=0)
        return self

    def apply(self, ds):
        if getattr(ds, "speaker_emb", None) is None and ds.speaker_name in self.mean_emb:
            ds.speaker_emb = self.mean_emb[ds.speaker_name]
        return ds

    def state_dict(self) -> dict:
        return {"mean_emb": {k: v.tolist() for k, v in self.mean_emb.items()}}

    def load_state_dict(self, d: dict) -> None:
        self.mean_emb = {k: np.asarray(v, np.float32) for k, v in d["mean_emb"].items()}

    def aggregate(self, other: "MeanBioEmbeddings") -> "MeanBioEmbeddings":
        self.mean_emb.update(other.mean_emb)
        return self


SINGLETON_HANDLERS = {"SpeakerIDSetter": SpeakerIDSetter,
                      "StatisticsRange": StatisticsRange,
                      "DatasetStatistics": DatasetStatistics,
                      "PhonemeStatistics": PhonemeStatistics,
                      "MeanBioEmbeddings": MeanBioEmbeddings}
