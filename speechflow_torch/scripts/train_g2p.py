"""G2P training (counterpart of ``speechflow_tpu/scripts/train_g2p.py``): mine
(lang, word, phonemes) entries from the corpus segs, train the chunk tagger,
report the held-out phoneme error rate, and save ``g2p.pkl`` (JAX's layout:
either package loads it). ``TTSEvaluationInterface`` finds a ``g2p.pkl``
beside a TTS checkpoint, and ``train_tts`` trains one into every experiment.

    python -m speechflow_torch.scripts.train_g2p --data-root tests/data/SEGS \\
        --output /tmp/g2p.pkl [--holdout 0.1] [--steps 1200] [--device cpu]

It trains on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import typing as tp
from pathlib import Path

import numpy as np

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["train_g2p_artifact", "held_out_scores", "main"]


def held_out_scores(g2p, held) -> tp.Tuple[float, float]:
    """(mean phoneme error rate, share of exact words) of ``g2p``'s tagger
    (the lexicon bypassed) over the (lang, word, phonemes) entries ``held``."""
    from speechflow_torch.models.g2p import phoneme_error_rate

    pers = []
    for lang in sorted({h[0] for h in held}):
        words = [w for hl, w, _ in held if hl == lang]
        preds = dict(zip(words, g2p.predict(words, lang, use_lexicon=False)))
        pers += [phoneme_error_rate(preds[w], pron) for hl, w, pron in held if hl == lang]
    return float(np.mean(pers)), float(np.mean([p == 0.0 for p in pers]))


def train_g2p_artifact(data_root, out_path, steps: int = 1200, holdout: float = 0.0,
                       seed: int = 0, **train_kwargs) -> str:
    """Mine the corpus at ``data_root``, train (``train_kwargs`` go to
    ``train_g2p``, ``device`` among them), save ``g2p.pkl`` to ``out_path`` (a
    directory gets ``g2p.pkl`` inside); returns the saved path. The held-out
    share of the word types (``numpy.random.default_rng(seed)``'s permutation,
    the first ``int(len · holdout)``) is scored and then joins the saved
    lexicon."""
    from speechflow_torch.models.g2p import mine_g2p_lexicon, train_g2p

    segs = sorted(Path(data_root).rglob("*.TextGrid*"))
    lexicon = mine_g2p_lexicon(segs)
    if not lexicon:
        raise ValueError(f"no (word, phoneme) pairs mined from {data_root}")
    LOGGER.info("mined %d (lang, word, pron) pairs from %d segs", len(lexicon), len(segs))

    idx = np.random.default_rng(seed).permutation(len(lexicon))
    n_held = int(len(lexicon) * holdout)
    held = [lexicon[i] for i in idx[:n_held]]
    train = [lexicon[i] for i in idx[n_held:]]

    g2p = train_g2p(train, steps=steps, seed=seed, **train_kwargs)
    if held:
        per, exact = held_out_scores(g2p, held)
        LOGGER.info("held-out PER over %d words: %.3f (exact %.3f)", len(held), per, exact)

    g2p.lexicon.update({(lg.upper(), w): p for lg, w, p in held})
    out = Path(out_path)
    if out.is_dir() or not out.suffix:
        out = out / "g2p.pkl"
    g2p.save(out)
    LOGGER.info("saved %s (lexicon %d, chunk classes %d)", out, len(g2p.lexicon),
                len(g2p.chunk_symbols))
    return str(out)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True,
                    help="directory scanned recursively for *.TextGrid* segs")
    ap.add_argument("--output", default="g2p.pkl",
                    help="output pickle path (a directory gets /g2p.pkl)")
    ap.add_argument("--holdout", type=float, default=0.1,
                    help="fraction of word types held out for the PER report")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--hidden", type=int, default=384)
    ap.add_argument("--dropout", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cpu, or the GPU when absent")
    args = ap.parse_args(argv)
    try:
        return train_g2p_artifact(args.data_root, args.output, steps=args.steps,
                                  holdout=args.holdout, seed=args.seed, hidden=args.hidden,
                                  dropout=args.dropout, device=args.device)
    except ValueError as e:
        raise SystemExit(str(e))


def cli() -> None:
    """Console entry point: exit-code semantics want None."""
    main()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
