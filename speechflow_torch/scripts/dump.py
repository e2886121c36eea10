"""Feature dump (counterpart of ``speechflow_tpu/scripts/dump.py``): every
sample of every subset through the handlers of a data config with the
feature cache on (``processor.dump`` at ``--dump_path``, ``full_dump``), so the
cache fills; then, over the processed samples,

- ``ranges.json``: per speaker and feature, the (1 %, 99 %) quantiles, mean and
  std that the ``StatisticsRange`` singleton reads (``ranges_file``) to
  normalise by speaker;
- ``prosody_centroids.npy``: the k-means centroids of the per-word pitch
  contours (10 points, voiced frames, divided by their mean), the classes
  ``prosody_annotation`` labels words with;
- ``dump_report.json``: samples a subset, speakers, contours and clusters.

The handlers run on the host, as in the data workers; a handler that runs a
model (a ``model_ckpt``) runs it where the handler puts it (the GPU).

    python -m speechflow_torch.scripts.dump -cd configs/tts_data_24khz.yml \\
        --dump_path dump [-vs debug] [--data_root tests/data/SEGS]
"""

from __future__ import annotations

import argparse
import json
import logging
import time
import typing as tp
from pathlib import Path

import numpy as np

from speechflow_torch.data.core.components import DataPipeline
from speechflow_torch.data.processors.singletons import StatisticsRange
from speechflow_torch.io.config import Config

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["extract_pitch_contours", "kmeans", "cluster_contours", "compute_ranges",
           "dump_config", "main"]


def contour_of(seg: np.ndarray, n_points: int = 10) -> tp.Optional[np.ndarray]:
    """A token's voiced pitch resampled to ``n_points`` and divided by its mean
    (None with fewer than 3 voiced frames)."""
    v = seg[seg > 0]
    if len(v) < 3:
        return None
    contour = np.interp(np.linspace(0, len(v) - 1, n_points), np.arange(len(v)), v)
    return contour / max(contour.mean(), 1e-6)


def extract_pitch_contours(samples, n_points: int = 10) -> np.ndarray:
    """(N, n_points) float32: the contour of every token with enough voiced
    frames, over the samples that have pitch and durations."""
    contours = []
    for ds in samples:
        if ds.pitch is None or ds.durations is None:
            continue
        edges = np.concatenate([[0], np.cumsum(ds.durations.astype(np.int64))])
        for i in range(len(ds.durations)):
            c = contour_of(ds.pitch[edges[i]:edges[i + 1]], n_points)
            if c is not None:
                contours.append(c)
    return np.asarray(contours, np.float32) if contours else np.zeros((0, n_points), np.float32)


def _sq_dist(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    return np.maximum((x * x).sum(1)[:, None] - 2.0 * x @ c.T + (c * c).sum(1)[None, :], 0.0)


def _kmeans_pp(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """Greedy k-means++ seeding: each new centre the best of 2 + ln(k)
    candidates drawn in proportion to the squared distance."""
    n_trials = 2 + int(np.log(k))
    centers = [x[rng.integers(len(x))]]
    d2 = _sq_dist(x, centers[0][None])[:, 0]
    for _ in range(1, k):
        probs = d2 / d2.sum() if d2.sum() > 0 else np.full(len(x), 1.0 / len(x))
        cand = rng.choice(len(x), size=n_trials, p=probs)
        cand_d2 = np.minimum(d2[None, :], _sq_dist(x, x[cand]).T)
        best = int(np.argmin(cand_d2.sum(1)))
        centers.append(x[cand[best]])
        d2 = cand_d2[best]
    return np.stack(centers)


def _hartigan(x: np.ndarray, labels: np.ndarray, k: int, max_passes: int = 50) -> np.ndarray:
    """Move single points between clusters while a move lowers the inertia
    (Hartigan's rule: moving x from a to b changes it by
    n_b/(n_b+1)|x-c_b|^2 - n_a/(n_a-1)|x-c_a|^2); a Lloyd fixed point is
    usually not one of these."""
    labels = labels.copy()
    counts = np.bincount(labels, minlength=k).astype(np.float64)
    sums = np.stack([x[labels == j].sum(0) for j in range(k)])
    for _ in range(max_passes):
        moved = False
        for i in range(len(x)):
            a = labels[i]
            if counts[a] <= 1:
                continue
            d2 = ((sums / np.maximum(counts, 1)[:, None] - x[i]) ** 2).sum(1)
            gain = counts / (counts + 1) * d2
            gain[a] = counts[a] / (counts[a] - 1) * d2[a]
            b = int(np.argmin(gain))
            if b != a and gain[b] < gain[a] * (1 - 1e-12):
                counts[a] -= 1
                counts[b] += 1
                sums[a] -= x[i]
                sums[b] += x[i]
                labels[i] = b
                moved = True
        if not moved:
            break
    return labels


def kmeans(x: np.ndarray, k: int, n_init: int = 4, seed: int = 0, max_iter: int = 300,
           tol: float = 1e-4) -> tp.Tuple[np.ndarray, float]:
    """(centroids (k, D), inertia) of the best of ``n_init`` runs from
    k-means++ seeds, all drawn from ``default_rng(seed)``: Lloyd's iterations
    until the centres move less than ``tol`` times the data's mean variance
    (squared), as sklearn's ``KMeans`` stops, then Hartigan's single-point
    moves, then Lloyd's again."""
    x = np.asarray(x, np.float64)
    rng = np.random.default_rng(seed)
    stop = tol * float(np.mean(np.var(x, axis=0)))

    def lloyd(c):
        for _ in range(max_iter):
            labels = np.argmin(_sq_dist(x, c), axis=1)
            new = np.stack([x[labels == j].mean(0) if np.any(labels == j) else c[j]
                            for j in range(k)])
            shift = float(((new - c) ** 2).sum())
            c = new
            if shift <= stop:
                break
        return c

    best_c, best_inertia = None, np.inf
    for _ in range(n_init):
        c = lloyd(_kmeans_pp(x, k, rng))
        labels = _hartigan(x, np.argmin(_sq_dist(x, c), axis=1), k)
        c = lloyd(np.stack([x[labels == j].mean(0) if np.any(labels == j) else c[j]
                            for j in range(k)]))
        inertia = float(_sq_dist(x, c).min(1).sum())
        if inertia < best_inertia:
            best_c, best_inertia = c, inertia
    return best_c, best_inertia


def cluster_contours(contours: np.ndarray, n_clusters: int = 8) -> np.ndarray:
    """``n_clusters`` k-means centroids of the contours (seed 0, 4 seedings),
    float32; fewer contours than clusters are returned as they are."""
    if len(contours) < n_clusters:
        return contours
    return kmeans(contours, n_clusters, n_init=4, seed=0)[0].astype(np.float32)


def compute_ranges(samples) -> tp.Dict[str, dict]:
    """Per speaker and feature, (1 %, 99 %) quantiles, mean and std of the
    processed samples' pitch (voiced), energy and their token aggregates."""
    return StatisticsRange().fit(list(samples)).ranges


def dump_config(path: tp.Union[str, Path], value_select: tp.Optional[tp.Sequence[str]],
                dump_path: tp.Union[str, Path],
                data_root: tp.Optional[tp.Union[str, Path]] = None) -> dict:
    """The data config at ``path`` with the whole-cache dump section at ``dump_path``."""
    cfg = Config.create_from_file(path, value_select=value_select).to_dict()
    if data_root:
        cfg.setdefault("dirs", {})["data_root"] = str(data_root)
    processor = cfg.get("processor") or {}
    processor["dump"] = dict(processor.get("dump") or {}, dump_path=str(dump_path),
                             full_dump=True)
    cfg["processor"] = processor
    return cfg


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="feature dump, ranges.json and prosody centroids")
    p.add_argument("-cd", "--data_config", required=True)
    p.add_argument("-vs", "--value_select", nargs="*", default=None)
    p.add_argument("--dump_path", required=True)
    p.add_argument("--data_root", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--n_prosody_clusters", type=int, default=8)
    p.add_argument("--full_dump", action="store_true", default=True)
    args = p.parse_args(argv)

    dump_path = Path(args.dump_path)
    dump_path.mkdir(parents=True, exist_ok=True)
    pipeline = DataPipeline.from_config(
        dump_config(args.data_config, args.value_select, dump_path, args.data_root))
    process = pipeline.process
    report: tp.Dict[str, tp.Any] = {"subsets": {}}
    all_samples, sample_ms = [], []
    for subset in pipeline.info["subsets"]:
        n = 0
        for ds in pipeline.datasets[subset]:
            t0 = time.perf_counter()
            out = process.sample(ds)
            sample_ms.append(1e3 * (time.perf_counter() - t0))
            if out is not None:
                all_samples.append(out)
                n += 1
        report["subsets"][subset] = n
        LOGGER.info("dumped %d samples for %s", n, subset)

    ranges = compute_ranges(all_samples)
    (dump_path / "ranges.json").write_text(json.dumps(ranges, indent=2))
    report["speakers_with_ranges"] = len(ranges)

    contours = extract_pitch_contours(all_samples)
    centroids = cluster_contours(contours, args.n_prosody_clusters)
    np.save(dump_path / "prosody_centroids.npy", centroids)
    report["n_contours"] = int(len(contours))
    report["n_prosody_clusters"] = int(len(centroids))

    (dump_path / "dump_report.json").write_text(json.dumps(report, indent=2))
    # this run's numbers, not the report's: the JAX report has no timings
    report["sample_ms"] = sample_ms
    report["cache_hits"], report["cache_misses"] = process.dump.hits, process.dump.misses
    LOGGER.info("dump complete: %s", {k: v for k, v in report.items() if k != "sample_ms"})
    return report


def cli() -> None:
    main()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
