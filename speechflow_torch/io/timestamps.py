"""Interval timestamps in seconds with frame conversion (counterpart of
``speechflow_tpu/io/timestamps.py``): an (N, 2) array of [begin, end)
intervals with shift/scale, slicing, concatenation and duration queries, and
``to_frames``, the bridge between TextGrid annotations and mel-frame
durations. Numpy only."""

from __future__ import annotations

import typing as tp

import numpy as np

__all__ = ["Timestamps"]


class Timestamps:
    def __init__(self, intervals: tp.Union[np.ndarray, tp.Sequence[tp.Sequence[float]]]):
        arr = np.asarray(intervals, dtype=np.float64)
        if arr.size == 0:
            arr = arr.reshape(0, 2)
        if arr.ndim != 2 or arr.shape[1] != 2:
            raise ValueError(f"Timestamps expects (N, 2), got {arr.shape}")
        self.intervals = arr

    def __len__(self) -> int:
        return len(self.intervals)

    def __getitem__(self, idx):
        """A row (begin, end), or a slice as ``Timestamps``."""
        out = self.intervals[idx]
        return Timestamps(out) if isinstance(idx, slice) else out

    def __iter__(self):
        return iter(self.intervals)

    def __eq__(self, other) -> bool:
        return isinstance(other, Timestamps) and np.array_equal(self.intervals, other.intervals)

    def __repr__(self) -> str:
        return f"Timestamps({self.intervals.tolist()})"

    @property
    def begin(self) -> float:
        return float(self.intervals[0, 0]) if len(self) else 0.0

    @property
    def end(self) -> float:
        return float(self.intervals[-1, 1]) if len(self) else 0.0

    @property
    def duration(self) -> float:
        return self.end - self.begin

    @property
    def durations(self) -> np.ndarray:
        return self.intervals[:, 1] - self.intervals[:, 0]

    def copy(self) -> "Timestamps":
        return Timestamps(self.intervals.copy())

    def shift(self, offset: float) -> "Timestamps":
        return Timestamps(self.intervals + offset)

    def scale(self, factor: float) -> "Timestamps":
        return Timestamps(self.intervals * factor)

    def append(self, other: "Timestamps") -> "Timestamps":
        """A new ``Timestamps``: these intervals, then ``other``'s."""
        return Timestamps(np.concatenate([self.intervals, other.intervals], axis=0))

    @staticmethod
    def from_durations(durations: tp.Sequence[float], begin: float = 0.0) -> "Timestamps":
        """Back-to-back intervals of the given lengths from ``begin``."""
        ends = begin + np.cumsum(np.asarray(durations, dtype=np.float64))
        begins = np.concatenate([[begin], ends[:-1]])
        return Timestamps(np.stack([begins, ends], axis=1))

    def to_frames(self, hop_len: int, sr: int, n_frames: tp.Optional[int] = None) -> np.ndarray:
        """Convert intervals to integer per-interval frame counts.

        Boundaries are rounded to the nearest frame; counts therefore sum to
        the (rounded) total span. If ``n_frames`` is given, the last interval
        absorbs the residual so counts sum exactly to ``n_frames`` (matching
        the reference's duration/mel-length reconciliation).
        """
        fps = sr / hop_len
        edges = np.round((self.intervals - self.begin) * fps).astype(np.int64)
        counts = edges[:, 1] - edges[:, 0]
        counts = np.maximum(counts, 0)
        if n_frames is not None and len(counts):
            diff = n_frames - counts.sum()
            counts[-1] += diff
            if counts[-1] < 0:
                # push deficit backwards through earlier intervals
                for i in range(len(counts) - 1, 0, -1):
                    if counts[i] < 0:
                        counts[i - 1] += counts[i]
                        counts[i] = 0
                counts[0] = max(counts[0], 0)
                # final fixup to guarantee the exact total
                counts[-1] += n_frames - counts.sum()
        return counts
