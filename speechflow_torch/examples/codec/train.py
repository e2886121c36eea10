"""Neural-codec training (counterpart of ``examples/codec/train.py``): the
residual-VQ codec (``models/codec/rvq.py``, ``CodecParams`` as JAX's example
sets them) trained on random chunks of the speech corpus with L1 + multi-
resolution STFT + commitment losses (``codec_criterion``) under
``optax.adam(3e-4)``; ``--save`` writes the ``save_module`` pickle that
``codec_features(model_ckpt=...)`` reads in both packages.

    python -m speechflow_torch.examples.codec.train [--steps 200] [--save /tmp/codec.pkl]
    python -m speechflow_torch.examples.codec.train --platform cpu --steps 2

It trains on the GPU unless ``--platform cpu``.
"""

from __future__ import annotations

import argparse
import typing as tp
from pathlib import Path

import numpy as np
import torch

DATA = Path(__file__).resolve().parents[3] / "tests" / "data" / "SEGS"
PARAMS = dict(channels=32, latent_dim=64, strides=(4, 8, 8), n_quantizers=4,
              codebook_size=256)

__all__ = ["DATA", "PARAMS", "draw_batch", "codec_step", "main"]


def draw_batch(rng: np.random.Generator, waves: tp.Sequence[np.ndarray], batch: int,
               n: int) -> np.ndarray:
    """(batch, n) random chunks of ``waves`` in JAX's draw order (a wave, then
    an offset; a short wave zero-padded)."""
    xs = []
    for _ in range(batch):
        w = waves[int(rng.integers(0, len(waves)))]
        if len(w) < n:
            w = np.pad(w, (0, n - len(w)))
        s = int(rng.integers(0, max(len(w) - n, 1)))
        xs.append(w[s:s + n])
    return np.stack(xs).astype(np.float32)


def codec_step(model, opt, crit, wav: torch.Tensor) -> torch.Tensor:
    """One optimizer step on the summed codec losses; returns the loss."""
    opt.zero_grad(set_to_none=True)
    loss = sum(crit(model(wav), {"waveform": wav}, 0).values())
    loss.backward()
    opt.step()
    return loss.detach()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--chunk_s", type=float, default=0.75)
    p.add_argument("--platform", default=None, help="cpu, or the GPU when absent")
    p.add_argument("--data_root", default=str(DATA))
    p.add_argument("--save", default=None, help="state_io checkpoint path")
    args = p.parse_args(argv)

    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.io.flist import construct_file_list
    from speechflow_torch.models.codec import CodecParams, NeuralCodec
    from speechflow_torch.models.codec.rvq import codec_criterion
    from speechflow_torch.models.layers import flax_init_
    from speechflow_torch.training.optimizer import optax_optimizer
    from speechflow_torch.utils.device import resolve_device

    dev = resolve_device(args.platform)
    files = construct_file_list(args.data_root, ext=".wav")
    waves = [AudioChunk(file_path=f).load(sr=24000).waveform for f in files]
    print(f"{len(waves)} utterances")

    params = CodecParams(**PARAMS)
    torch.manual_seed(0)
    model = flax_init_(NeuralCodec(params)).to(dev).train()
    opt = optax_optimizer(model.parameters(), "adam", 3e-4)
    crit = codec_criterion(sample_rate=24000)

    rng = np.random.default_rng(0)
    n = int(args.chunk_s * 24000)
    n -= n % int(np.prod(params.strides))
    first = last = None
    for it in range(args.steps):
        wav = torch.from_numpy(draw_batch(rng, waves, args.batch, n)).to(dev)
        loss = float(codec_step(model, opt, crit, wav))
        first = loss if first is None else first
        last = loss
        if it % 50 == 0:
            print(f"step {it}: loss {loss:.4f}")
    print(f"codec loss: {first:.3f} -> {last:.3f}")

    if args.save:
        from speechflow_torch.utils.state_io import save_module

        save_module(model, params, args.save)
        print(f"saved codec -> {args.save}")
    return model.eval()


if __name__ == "__main__":
    main()
