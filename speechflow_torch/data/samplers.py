"""Batch samplers (counterpart of ``SimpleSampler``, ``RandomSampler`` and
``TripletSampler`` in ``speechflow_tpu/data/samplers.py``): ``sampling(batch_size)
-> (samples, is_last)`` over a list of samples, the order reset at the end of
each epoch. ``SimpleSampler`` walks in order (or by length with
``comb_by_len``, or greedily up to ``tokens_per_batch``); ``RandomSampler``
shuffles each epoch with ``random.Random(seed + epoch)`` (in length-sorted
blocks of 64 with ``comb_by_len``); ``TripletSampler`` draws anchor,
positive and negative samples for metric learning."""

from __future__ import annotations

import random
import typing as tp

import numpy as np

__all__ = ["SimpleSampler", "RandomSampler", "TripletSampler", "SAMPLERS"]


class SimpleSampler:
    def __init__(self, comb_by_len: bool = False, seed: int = 0,
                 tokens_per_batch: tp.Optional[int] = None):
        self.dataset: tp.Sequence = []
        self.epoch = 0
        self.comb_by_len = comb_by_len
        self.seed = seed
        self.tokens_per_batch = tokens_per_batch
        self._order: tp.List[int] = []
        self._pos = 0

    def set_dataset(self, dataset: tp.Sequence) -> "SimpleSampler":
        self.dataset = dataset
        self.reset()
        return self

    def __len__(self) -> int:
        return len(self.dataset)

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


class TripletSampler:
    """``batch_size`` triplets a draw, flattened as [anchors, positives,
    negatives]: an anchor's positive shares its ``field`` (a label with at
    least two samples), its negative has another. Each draw's generator is
    ``numpy.random.default_rng(seed + epoch·31337 + drawn)``, JAX's; an epoch
    ends once a dataset's worth of triplets has been drawn."""

    def __init__(self, field: str = "speaker_name", seed: int = 0):
        self.dataset: tp.Sequence = []
        self.epoch = 0
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
            "TripletSampler": TripletSampler}
