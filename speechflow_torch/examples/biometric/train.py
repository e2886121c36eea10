"""Triplet speaker-verification training (counterpart of
``examples/biometric/train.py``): ``AudioDSParser`` over the speech corpus,
log-mel features of random 1.5 s chunks, ``TripletSampler`` batches, and the
ECAPA embedder (``ECAPAParams`` as JAX's example sets them) under the cosine
triplet loss and ``optax.adam(1e-3)``; ``--save`` writes the ``save_module``
pickle that ``voice_biometrics(model_ckpt=...)`` reads in both packages.

    python -m speechflow_torch.examples.biometric.train [--steps 60] [--save /tmp/ecapa.pkl]
    python -m speechflow_torch.examples.biometric.train --platform cpu --steps 2

It trains on the GPU unless ``--platform cpu``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

DATA = Path(__file__).resolve().parents[3] / "tests" / "data" / "SEGS"
PARAMS = dict(n_mels=80, channels=64, emb_dim=64, n_blocks=2)

__all__ = ["DATA", "PARAMS", "featurize", "triplet_mels", "triplet_step", "main"]


def featurize(ds):
    """A sample's log-mel (80 bands) of a random 1.5 s chunk (seeded by its
    index), through the port's handlers."""
    from speechflow_torch.data.processors.audio import load_audio, random_chunk
    from speechflow_torch.data.processors.spectral import amp_to_db, linear_to_mel, magnitude

    ds = load_audio(ds, sample_rate=24000)
    ds = random_chunk(ds, chunk_duration=1.5, seed=ds.index)
    ds = magnitude(ds, n_fft=1024, hop_len=256)
    ds = linear_to_mel(ds, n_mels=80)
    return amp_to_db(ds)


def triplet_mels(samples) -> np.ndarray:
    """(3B, T, 80): each sample's first 128 log-mel frames, zero-padded to the
    longest."""
    mels = [featurize(s.copy()).mel[:128] for s in samples]
    t = max(len(m) for m in mels)
    return np.stack([np.pad(m, ((0, t - len(m)), (0, 0))) for m in mels]).astype(np.float32)


def triplet_step(model, opt, mel: torch.Tensor) -> torch.Tensor:
    """One optimizer step on the triplet loss of [anchors, positives,
    negatives]; returns the loss."""
    from speechflow_torch.models.biometric import triplet_loss

    opt.zero_grad(set_to_none=True)
    a, p, n = torch.chunk(model(mel), 3, dim=0)
    loss = triplet_loss(a, p, n)
    loss.backward()
    opt.step()
    return loss.detach()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch", type=int, default=4)  # triplets per step
    p.add_argument("--platform", default=None, help="cpu, or the GPU when absent")
    p.add_argument("--data_root", default=str(DATA))
    p.add_argument("--save", default=None, help="save the trained embedder (state_io pickle)")
    args = p.parse_args(argv)

    from speechflow_torch.data.parsers import AudioDSParser
    from speechflow_torch.data.samplers import TripletSampler
    from speechflow_torch.io.flist import construct_file_list
    from speechflow_torch.models.biometric import ECAPAEmbedder, ECAPAParams
    from speechflow_torch.training.optimizer import optax_optimizer
    from speechflow_torch.utils.device import resolve_device

    dev = resolve_device(args.platform)
    dataset = AudioDSParser().read_datasamples(construct_file_list(args.data_root, ext=".wav"))
    print(f"{len(dataset)} utterances, speakers: "
          f"{sorted({dataset[i].speaker_name for i in range(len(dataset))})}")
    sampler = TripletSampler(field="speaker_name").set_dataset(dataset)
    params = ECAPAParams(**PARAMS)
    torch.manual_seed(0)
    model = ECAPAEmbedder(params).to(dev).train()
    opt = optax_optimizer(model.parameters(), "adam", 1e-3)

    first = last = None
    for it in range(args.steps):
        samples, _ = sampler.sampling(args.batch)
        loss = float(triplet_step(model, opt, torch.from_numpy(triplet_mels(samples)).to(dev)))
        first = loss if first is None else first
        last = loss
        if it % 20 == 0:
            print(f"step {it}: triplet loss {loss:.4f}")
    print(f"triplet loss: {first:.3f} -> {last:.3f}")
    if args.save:
        from speechflow_torch.utils.state_io import save_module

        save_module(model, params, args.save)
        print(f"saved embedder -> {args.save}")
    return model.eval()


if __name__ == "__main__":
    main()
