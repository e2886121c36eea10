"""Figures as image arrays for TensorBoard (counterpart of
``speechflow_tpu/utils/plotting.py``): a spectrogram or an attention map, and
1-D signals overlaid, each rendered by matplotlib's Agg backend to an
(H, W, 3) uint8 array. matplotlib is imported on the first call; where it is
not installed the call raises ``ImportError`` naming it."""

from __future__ import annotations

import typing as tp

import numpy as np

__all__ = ["plot_spectrogram", "plot_1d_overlay", "figure_to_array"]


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the training visualizer's figures need matplotlib, which is "
                          "not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def figure_to_array(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    _pyplot().close(fig)
    return buf


def plot_spectrogram(spec: np.ndarray, title: str = "") -> np.ndarray:
    """(T, F) -> (H, W, 3): frequency up, time across."""
    fig, ax = _pyplot().subplots(figsize=(8, 3), dpi=80)
    im = ax.imshow(np.asarray(spec).T, aspect="auto", origin="lower", interpolation="none")
    if title:
        ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return figure_to_array(fig)


def plot_1d_overlay(signals: tp.Dict[str, np.ndarray], title: str = "") -> np.ndarray:
    fig, ax = _pyplot().subplots(figsize=(8, 2.5), dpi=80)
    for name, sig in signals.items():
        ax.plot(np.asarray(sig), label=name, lw=1)
    ax.legend(fontsize="small")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    return figure_to_array(fig)
