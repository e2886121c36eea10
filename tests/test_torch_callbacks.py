"""The training callbacks (``speechflow_torch.training.callbacks``) against the JAX
package's: ``TTSTrainingVisualizer`` plots the same predicted mel, target mel and
attention of the debug acoustic model (weights converted, the wrapper decoder:
no draws) within 1e-5 of scale, through a ``plot_spectrogram`` whose image is
JAX's pixel for pixel; ``GradNormCallback`` logs JAX's parameter-delta norm;
neither writes without a TensorBoard writer; matplotlib's absence raises by name."""

import sys
import types

import numpy as np
import pytest
import torch

from speechflow_torch.data.collate import CollatedTTS
from speechflow_torch.models.tts.batch_processor import TTSBatchProcessor
from speechflow_torch.training import callbacks
from speechflow_torch.utils import plotting

torch.set_num_threads(1)


class _TB:
    def __init__(self):
        self.images, self.scalars = {}, {}

    def add_image(self, tag, img, step, dataformats="CHW"):
        self.images[tag] = (img, step, dataformats)

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((value, step))


def _collated(arrays: dict) -> CollatedTTS:
    names = set(CollatedTTS.__dataclass_fields__)
    return CollatedTTS(**{k: v for k, v in arrays.items() if k in names})


def test_plot_spectrogram_is_jax_s_image():
    from speechflow_tpu.utils.plotting import plot_spectrogram as jplot

    spec = np.random.default_rng(0).normal(size=(50, 20)).astype(np.float32)
    img = plotting.plot_spectrogram(spec, "mel")
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[-1] == 3
    np.testing.assert_array_equal(img, jplot(spec, "mel"))
    sig = {"pitch": np.sin(np.arange(40) / 5.0), "energy": np.cos(np.arange(40) / 7.0)}
    from speechflow_tpu.utils.plotting import plot_1d_overlay as joverlay

    np.testing.assert_array_equal(plotting.plot_1d_overlay(sig), joverlay(sig))


def test_visualizer_plots_jax_s_arrays(monkeypatch):
    from speechflow_tpu.models.tts.batch_processor import TTSBatchProcessor as JBP
    from speechflow_tpu.training import callbacks as jcallbacks

    from tests.test_torch_tts_train import _batch, _pair

    jm, model = _pair("wrapper")
    collated = _collated(_batch(0))
    plotted = {"jax": [], "port": []}
    for key, mod in (("jax", jcallbacks), ("port", callbacks)):
        monkeypatch.setattr(mod, "plot_spectrogram",
                            lambda x, title="", key=key: plotted[key].append(np.asarray(x))
                            or np.zeros((2, 2, 3), np.uint8))
    jtrainer = types.SimpleNamespace(_tb=_TB(), global_step=4, model=jm,
                                     batch_processor=JBP())
    trainer = types.SimpleNamespace(_tb=_TB(), global_step=4, model=model.train(),
                                    batch_processor=TTSBatchProcessor(),
                                    device=torch.device("cpu"))
    jcallbacks.TTSTrainingVisualizer(lambda: collated, every=2)(jtrainer, {})
    callbacks.TTSTrainingVisualizer(lambda: collated, every=2)(trainer, {})
    assert set(trainer._tb.images) == set(jtrainer._tb.images) == {"pred_mel", "gt_mel",
                                                                    "attention"}
    assert len(plotted["port"]) == len(plotted["jax"]) == 3
    for ours, ref in zip(plotted["port"], plotted["jax"]):
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=1e-5 * max(np.abs(ref).max(), 1.0))
    trainer._tb.images.clear()
    trainer.global_step = 5
    callbacks.TTSTrainingVisualizer(lambda: collated, every=2)(trainer, {})
    assert not trainer._tb.images


def test_grad_norm_callback_logs_the_parameter_delta():
    model = torch.nn.Linear(4, 3)
    trainer = types.SimpleNamespace(_tb=_TB(), global_step=0, model=model)
    cb = callbacks.GradNormCallback(every=2)
    before = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).clone()
    cb(trainer, {})
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.5)
    trainer.global_step = 1
    cb(trainer, {})  # not a multiple of every: nothing
    trainer.global_step = 2
    cb(trainer, {})
    (value, step), = trainer._tb.scalars["param_delta_norm"]
    after = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    assert step == 2 and value == pytest.approx(float(torch.linalg.vector_norm(after - before)))
    assert value == pytest.approx(0.5 * np.sqrt(15))
    silent = types.SimpleNamespace(_tb=None, global_step=0, model=model)
    callbacks.GradNormCallback(every=1)(silent, {})  # no writer: nothing, no error


def test_missing_matplotlib_raises_by_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plotting.plot_spectrogram(np.zeros((4, 3), np.float32))
