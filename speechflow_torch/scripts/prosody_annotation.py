"""Prosody annotation (counterpart of ``speechflow_tpu/scripts/prosody_annotation.py``):
every sample of a data config through its handlers (and the cache ``dump``
filled at ``--dump_path``); each token with enough voiced frames gets the class
of the nearest of the dump's ``prosody_centroids.npy``, each word the most
common class of its phonemes' tokens ("undefined" where none has one), and the
words' classes are written as the ``prosody`` tier into the TextGrid the sample
came from, in place (``io/seg.py``).

    python -m speechflow_torch.scripts.prosody_annotation \\
        -cd configs/tts_data_24khz.yml --dump_path dump [-vs debug] [--data_root ...]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from speechflow_torch.data.core.components import DataPipeline
from speechflow_torch.io.seg import AudioSeg, Tier
from speechflow_torch.scripts.dump import contour_of, dump_config

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["assign_contour_class", "word_labels", "main"]


def assign_contour_class(pitch: np.ndarray, durations: np.ndarray,
                         centroids: np.ndarray, n_points: int = 10) -> np.ndarray:
    """Per token, the index of the nearest centroid to its contour (-1 with
    fewer than 3 voiced frames)."""
    edges = np.concatenate([[0], np.cumsum(durations.astype(np.int64))])
    out = np.full(len(durations), -1, np.int64)
    for i in range(len(durations)):
        contour = contour_of(pitch[edges[i]:edges[i + 1]], n_points)
        if contour is not None:
            out[i] = int(np.argmin(np.linalg.norm(centroids - contour, axis=1)))
    return out


def word_labels(seg: AudioSeg, classes: np.ndarray) -> list:
    """(begin, end, label) of each word of ``seg``: the most common class of
    the tokens of the phonemes inside it (token k + 1 for phoneme k, after
    BOS), else "undefined"."""
    phs = seg.phonemes()
    out = []
    for wb, we, _ in seg.words():
        tok = [classes[k + 1] if k + 1 < len(classes) else -1
               for k, (b, e, _) in enumerate(phs) if b >= wb - 1e-6 and e <= we + 1e-6]
        tok = [c for c in tok if c >= 0]
        out.append((wb, we, str(max(set(tok), key=tok.count)) if tok else "undefined"))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the prosody tier from the dump's centroids")
    p.add_argument("-cd", "--data_config", required=True)
    p.add_argument("-vs", "--value_select", nargs="*", default=None)
    p.add_argument("--dump_path", required=True)
    p.add_argument("--data_root", default=None)
    args = p.parse_args(argv)

    centroids = np.load(Path(args.dump_path) / "prosody_centroids.npy")
    dp = DataPipeline.from_config(dump_config(args.data_config, args.value_select,
                                              args.dump_path, args.data_root))
    process = dp.process
    n_annotated = 0
    for subset in dp.info["subsets"]:
        for sample in dp.datasets[subset]:
            ds = process.sample(sample)
            if ds is None or ds.pitch is None or ds.durations is None:
                continue
            classes = assign_contour_class(ds.pitch, ds.durations, centroids)
            seg = AudioSeg.load(ds.sega_path)
            seg.grid.add(Tier("prosody", word_labels(seg, classes)))
            seg.save(ds.sega_path)
            n_annotated += 1
    LOGGER.info("annotated %d segs with prosody classes", n_annotated)
    print(f"annotated {n_annotated} segas ({len(centroids)} classes)")
    return n_annotated


def cli() -> None:
    main()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
