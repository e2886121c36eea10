"""Batch samplers (counterpart of ``SimpleSampler``, ``RandomSampler`` and
``TripletSampler`` in ``speechflow_tpu/data/samplers.py``): ``sampling(batch_size)
-> (samples, is_last)`` over a list of samples, the order reset at the end of
each epoch. ``SimpleSampler`` walks in order (or by length with
``comb_by_len``, or greedily up to ``tokens_per_batch``); ``RandomSampler``
shuffles each epoch with ``random.Random(seed + epoch)`` (in length-sorted
blocks of 64 with ``comb_by_len``); ``WeightedSampler`` draws by inverse
frequency of sample fields, ``FillingSampler`` the least-seen field values
first; ``TripletSampler`` draws anchor, positive and negative samples for
metric learning. The drawing samplers take each draw's generator from
``numpy.random.default_rng(seed + epoch·k + drawn)``, JAX's, so a seed gives
JAX's batches."""

from __future__ import annotations

import random
import typing as tp

import numpy as np

__all__ = ["BaseSampler", "SimpleSampler", "RandomSampler", "WeightedSampler", "FillingSampler",
           "TripletSampler", "SAMPLERS"]


class BaseSampler:
    """A sampler over a list of samples: ``set_dataset`` (which resets the
    order), ``len``, ``reset`` at an epoch's end, and ``sampling(batch_size)
    -> (samples, is_last)``, which each sampler defines."""

    def __init__(self):
        self.dataset: tp.Sequence = []
        self.epoch = 0

    def set_dataset(self, dataset: tp.Sequence) -> "BaseSampler":
        self.dataset = dataset
        self.reset()
        return self

    def reset(self) -> None:
        pass

    def __len__(self) -> int:
        return len(self.dataset)

    def sampling(self, batch_size: int) -> tp.Tuple[list, bool]:
        raise NotImplementedError


class SimpleSampler(BaseSampler):
    def __init__(self, comb_by_len: bool = False, seed: int = 0,
                 tokens_per_batch: tp.Optional[int] = None):
        super().__init__()
        self.comb_by_len = comb_by_len
        self.seed = seed
        self.tokens_per_batch = tokens_per_batch
        self._order: tp.List[int] = []
        self._pos = 0

    def reset(self) -> None:
        self._order = list(range(len(self.dataset)))
        if self.comb_by_len:
            lens = [len(self.dataset[i]) for i in self._order]
            self._order = [i for _, i in sorted(zip(lens, self._order))]
        self._pos = 0
        self.epoch += 1

    def sampling(self, batch_size: int) -> tp.Tuple[list, bool]:
        n = len(self._order)
        if self.tokens_per_batch is None:
            take = self._order[self._pos:self._pos + batch_size]
            self._pos += batch_size
        else:
            take, total = [], 0
            while self._pos < n and len(take) < batch_size:
                i = self._order[self._pos]
                length = len(self.dataset[i]) or 1
                if take and total + length > self.tokens_per_batch:
                    break
                take.append(i)
                total += length
                self._pos += 1
        is_last = self._pos >= n
        samples = [self.dataset[i] for i in take]
        if is_last:
            self.reset()
        return samples, is_last


class RandomSampler(SimpleSampler):
    def reset(self) -> None:
        super().reset()
        rng = random.Random(self.seed + self.epoch)
        if self.comb_by_len:
            blocks = [self._order[i:i + 64] for i in range(0, len(self._order), 64)]
            for b in blocks:
                rng.shuffle(b)
            rng.shuffle(blocks)
            self._order = [i for b in blocks for i in b]
        else:
            rng.shuffle(self._order)


class WeightedSampler(BaseSampler):
    """Draws with replacement, a sample's weight ∝ 1 / count(its value)^alpha for
    each of ``fields`` (normalised per field). Each batch first picks a field by
    ``chunks_ratio`` (even by default), then ``batch_size`` samples by that
    field's weights, with ``default_rng(seed + epoch·100003 + drawn)``. An
    epoch is ``epoch_size`` draws (the dataset's size by default)."""

    def __init__(self, fields: tp.Sequence[str] = ("speaker_name",), alpha: float = 1.0,
                 epoch_size: tp.Optional[int] = None,
                 chunks_ratio: tp.Optional[tp.Sequence[float]] = None, seed: int = 0):
        super().__init__()
        self.fields = list(fields)
        self.alpha = alpha
        self.epoch_size = epoch_size
        self.chunks_ratio = (list(chunks_ratio) if chunks_ratio
                             else [1.0 / len(self.fields)] * len(self.fields))
        self.seed = seed
        self._weights: tp.List[np.ndarray] = []
        self._drawn = 0

    def set_dataset(self, dataset: tp.Sequence) -> "WeightedSampler":
        self.dataset = dataset
        self._weights = []
        for fld in self.fields:
            vals = [getattr(s, fld, None) for s in dataset]
            freq: tp.Dict[tp.Any, int] = {}
            for v in vals:
                freq[v] = freq.get(v, 0) + 1
            w = np.asarray([1.0 / freq[v] ** self.alpha for v in vals], np.float64)
            self._weights.append(w / w.sum())
        self.reset()
        return self

    def __len__(self) -> int:
        return len(self.dataset)

    def reset(self) -> None:
        self._drawn = 0
        self.epoch += 1

    def probabilities(self, field: str) -> np.ndarray:
        return self._weights[self.fields.index(field)]

    def sampling(self, batch_size: int) -> tp.Tuple[list, bool]:
        rng = np.random.default_rng(self.seed + self.epoch * 100003 + self._drawn)
        u, acc, fi = rng.uniform(), 0.0, 0
        for i, r in enumerate(self.chunks_ratio):
            acc += r
            if u <= acc:
                fi = i
                break
        idx = rng.choice(len(self.dataset), size=batch_size, p=self._weights[fi])
        self._drawn += batch_size
        is_last = self._drawn >= (self.epoch_size or len(self.dataset))
        if is_last:
            self.reset()
        return [self.dataset[int(i)] for i in idx], is_last


class FillingSampler(BaseSampler):
    """Each draw takes the least-seen combination of ``fields`` (ties broken by a
    uniform draw), then a sample of it, with ``default_rng(seed + epoch·7919 +
    drawn)``; an epoch is a dataset's worth of draws."""

    def __init__(self, fields: tp.Sequence[str] = ("speaker_name",), seed: int = 0):
        super().__init__()
        self.fields = list(fields)
        self.seed = seed
        self._seen: tp.Dict[tp.Any, int] = {}
        self._by_key: tp.Dict[tp.Any, tp.List[int]] = {}
        self._drawn = 0

    def set_dataset(self, dataset: tp.Sequence) -> "FillingSampler":
        self.dataset = dataset
        self._by_key = {}
        for i, s in enumerate(dataset):
            self._by_key.setdefault(tuple(getattr(s, f, None) for f in self.fields),
                                    []).append(i)
        self._seen = {k: 0 for k in self._by_key}
        self.reset()
        return self

    def __len__(self) -> int:
        return len(self.dataset)

    def reset(self) -> None:
        self._drawn = 0
        self.epoch += 1

    def sampling(self, batch_size: int) -> tp.Tuple[list, bool]:
        rng = np.random.default_rng(self.seed + self.epoch * 7919 + self._drawn)
        out = []
        for _ in range(batch_size):
            key = min(self._seen, key=lambda k: (self._seen[k], rng.uniform()))
            self._seen[key] += 1
            out.append(self.dataset[int(rng.choice(self._by_key[key]))])
        self._drawn += batch_size
        is_last = self._drawn >= len(self.dataset)
        if is_last:
            self.reset()
        return out, is_last


class TripletSampler(BaseSampler):
    """``batch_size`` triplets a draw, flattened as [anchors, positives,
    negatives]: an anchor's positive shares its ``field`` (a label with at
    least two samples), its negative has another. Each draw's generator is
    ``numpy.random.default_rng(seed + epoch·31337 + drawn)``, JAX's; an epoch
    ends once a dataset's worth of triplets has been drawn."""

    def __init__(self, field: str = "speaker_name", seed: int = 0):
        super().__init__()
        self.field = field
        self.seed = seed
        self._by_label: tp.Dict[tp.Any, tp.List[int]] = {}
        self._labels: tp.List[tp.Any] = []
        self._drawn = 0

    def set_dataset(self, dataset: tp.Sequence) -> "TripletSampler":
        self.dataset = dataset
        self._by_label = {}
        for i in range(len(dataset)):
            self._by_label.setdefault(getattr(dataset[i], self.field, None), []).append(i)
        self._labels = [lab for lab, idxs in self._by_label.items() if len(idxs) >= 2]
        if len(self._labels) < 2:
            raise ValueError("triplet sampling needs >=2 labels with >=2 samples")
        self.reset()
        return self

    def __len__(self) -> int:
        return len(self.dataset)

    def reset(self) -> None:
        self._drawn = 0
        self.epoch += 1

    def sampling(self, batch_size: int) -> tp.Tuple[list, bool]:
        rng = np.random.default_rng(self.seed + self.epoch * 31337 + self._drawn)
        labels = list(self._by_label)
        anchors, positives, negatives = [], [], []
        for _ in range(batch_size):
            lab = self._labels[int(rng.integers(0, len(self._labels)))]
            a, p = rng.choice(self._by_label[lab], size=2, replace=False)
            other = lab
            while other == lab:
                other = labels[int(rng.integers(0, len(labels)))]
            anchors.append(self.dataset[int(a)])
            positives.append(self.dataset[int(p)])
            negatives.append(self.dataset[int(rng.choice(self._by_label[other]))])
        self._drawn += batch_size
        is_last = self._drawn >= len(self.dataset)
        if is_last:
            self.reset()
        return anchors + positives + negatives, is_last


SAMPLERS = {"SimpleSampler": SimpleSampler, "RandomSampler": RandomSampler,
            "WeightedSampler": WeightedSampler, "FillingSampler": FillingSampler,
            "TripletSampler": TripletSampler}
