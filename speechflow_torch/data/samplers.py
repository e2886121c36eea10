"""Batch samplers (counterpart of ``SimpleSampler`` and ``RandomSampler`` in
``speechflow_tpu/data/samplers.py``): ``sampling(batch_size) -> (samples,
is_last)`` over a list of samples, the order reset at the end of each epoch.
``SimpleSampler`` walks in order (or by length with ``comb_by_len``, or
greedily up to ``tokens_per_batch``); ``RandomSampler`` shuffles each epoch
with ``random.Random(seed + epoch)`` (in length-sorted blocks of 64 with
``comb_by_len``)."""

from __future__ import annotations

import random
import typing as tp

__all__ = ["SimpleSampler", "RandomSampler", "SAMPLERS"]


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


SAMPLERS = {"SimpleSampler": SimpleSampler, "RandomSampler": RandomSampler}
