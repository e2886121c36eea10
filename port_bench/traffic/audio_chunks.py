"""Vocoder training traffic: micro-batches of fixed-length audio chunks cut by the
seed from a corpus of WAV files, as the recipe's data pipeline cuts them
(``load_audio`` at the sample rate, ``volume_normalize`` to a 0.95 peak,
``random_chunk`` of ``chunk_duration`` seconds, ``multiple_audio`` padding the
chunk with zeros to a multiple of the hop) and ``AudioCollate`` stacks them.

The corpus is read once and held on the device; a micro-batch is one gather
of its rows. The corpus lies outside the benchmark's folder, so its SHA-256 is
part of the workload: a changed corpus stops the run. Every seed draws the same
number of chunks from the same corpus: which utterance each row comes from,
and where in it, is the seed's.
"""

from __future__ import annotations

import hashlib
import typing as tp
import wave
from pathlib import Path

import numpy as np
import torch


def read_wav(path: Path) -> tp.Tuple[int, np.ndarray]:
    """(rate, float32 mono samples in [-1, 1]) of a 16-bit PCM WAV file."""
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: {8 * w.getsampwidth()}-bit samples, 16 expected")
        data = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
        rate, channels = w.getframerate(), w.getnchannels()
    x = data.reshape(-1, channels).astype(np.float32) / 32768.0
    return rate, x.mean(axis=1) if channels > 1 else x[:, 0]


def make_batches(params: dict, seed: int, device, root: Path) -> "Chunks":
    """The workload's micro-batches for ``seed``: the training drivers' entry."""
    return Chunks(params, seed, device, root)


class Chunks:
    """The corpus on the device and a seeded plan of chunk starts."""

    def __init__(self, params: dict, seed: int, device, root: Path):
        files = sorted((root / params["corpus"]).rglob("*.wav"))
        if not files:
            raise FileNotFoundError(f"no WAV files under {root / params['corpus']}")
        sr, hop = params["sample_rate"], params["hop"]
        waves, digest = [], hashlib.sha256()
        for f in files:
            rate, x = read_wav(f)
            if rate != sr:
                raise ValueError(f"{f}: {rate} Hz, the recipe loads at {sr}")
            digest.update(x.tobytes())
            peak = np.abs(x).max()
            waves.append(x * (params["peak"] / peak) if peak > 0 else x)
        if digest.hexdigest() != params["corpus_sha256"]:
            raise ValueError(f"the corpus under {params['corpus']} is not the one this "
                             f"workload was measured on (sha256 {digest.hexdigest()})")
        self.n = int(round(params["chunk_duration"] * sr))
        self.width = -(-self.n // hop) * hop
        self.batch = params["batch"]
        starts, at = [], 0
        for x in waves:
            starts.append(at)
            at += len(x)
        lens = np.array([len(x) for x in waves])
        if (lens <= self.n).any():
            raise ValueError("an utterance is not longer than a chunk")
        rng = np.random.default_rng(seed)
        total = params["micro_batches"] * self.batch
        utt = rng.integers(0, len(waves), total)
        # random_chunk: begin uniform in [0, dur - chunk) seconds, rounded to a sample
        begin = np.round(rng.uniform(0.0, (lens[utt] - self.n) / sr) * sr).astype(np.int64)
        self.plan = torch.as_tensor(np.array(starts)[utt] + begin, device=device).view(
            params["micro_batches"], self.batch)
        self.audio = torch.as_tensor(np.concatenate(waves), device=device)
        self.offsets = torch.arange(self.n, device=device)
        self.seconds = self.batch * self.n / sr  # audio a micro-batch, padding left out

    def __len__(self) -> int:
        return self.plan.shape[0]

    def batch_at(self, i: int) -> torch.Tensor:
        """Micro-batch i: (batch, width) float32 on the device."""
        rows = self.audio[self.plan[i % len(self)][:, None] + self.offsets]
        return torch.nn.functional.pad(rows, (0, self.width - self.n))
