"""Acoustic-model training (counterpart of ``speechflow_tpu/scripts/train_tts.py``).

Builds the data (``configs/tts_data_24khz.yml``: TextGrid files -> mel,
pitch, energy, durations and the text features), sizes the model from the
pipeline (``model_config_from_info``), builds its criterion, batch processor
and ``Trainer`` and ``fit``s, with checkpoints that carry the pipeline info
and the model params. Two model types, as in JAX:

- ``parallel`` (``configs/tts_model.yml``): ``ParallelTTSModel`` with
  ``TTSCriterion``; ``TTSEvaluationInterface.from_checkpoint`` serves it;
- ``xtts`` (``configs/xtts_model.yml``): ``XTTSModel``, a GPT over the codes
  its codec encodes from the target waveform, with ``xtts_criterion`` and
  ``XTTSBatchProcessor``; with ``use_prompt`` the collate becomes
  ``TTSCollateWithPrompt`` and the prompt encoder takes the pipeline's mel
  bins. ``XTTSEvaluationInterface`` serves it.

The configs are presets transcribed per ``value_select`` from the YAML
files (CPU tests hold them equal): ``-c`` picks the recipe by its path in
the repository, one of ``RECIPES``, and raises on any other path (the port
has no YAML reader yet); ``-cd`` takes ``configs/tts_data_24khz.yml``.

    python -m speechflow_torch.scripts.train_tts -vs debug --device cpu --max_steps 4
    python -m speechflow_torch.scripts.train_tts -c configs/xtts_model.yml -vs debug \
        --device cpu --max_steps 2
    python -m speechflow_torch.scripts.train_tts -c configs/xtts_model.yml   # on the GPU

It runs on the GPU unless ``device="cpu"``. Weights start from
``torch.manual_seed(trainer.seed)``; ``resume.from`` (``-r``),
``finetune.ckpt`` and ``warmstart.ckpt`` (``-w``, with ``include`` /
``exclude``) read the port's own checkpoints (``common.apply_resume_warmstart``).
Every experiment tries to train a G2P into its directory, as the JAX script
does, inside a guard that logs a failure and goes on: the G2P trainer
(``scripts/train_g2p.py``) is not ported yet, so the guard logs that and the
eval interfaces use the char fallback.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import logging
import typing as tp
from pathlib import Path

import torch

from speechflow_torch.models.tts import (
    ParallelTTSModel,
    ParallelTTSParams,
    TTSCriterion,
    XTTSBatchProcessor,
    XTTSModel,
    XTTSParams,
    xtts_criterion,
)
from speechflow_torch.models.tts.batch_processor import TTSBatchProcessor
from speechflow_torch.scripts.common import (
    XTTS_MODEL_PRESETS,
    XTTS_TRAIN_PRESETS,
    apply_resume_warmstart,
    build_data,
    experiment_saver,
    model_config_from_info,
    optimizer_config,
    trainer_config,
)
from speechflow_torch.serving import TTS_MODEL_PRESETS
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.training.trainer import Trainer
from speechflow_torch.utils.device import resolve_device
from speechflow_torch.utils.init import filter_kwargs

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["TTS_TRAIN_PRESETS", "TTS_DATA_PRESETS", "RECIPES", "configs", "recipe_of",
           "data_config_of", "build_model", "train", "main"]

REPO = Path(__file__).resolve().parents[2]


def _train_preset(debug: bool) -> dict:
    def pick(default, dbg):
        return dbg if debug else default

    return {
        "experiment": {"name": "tts_cfm", "base_dir": "experiments", "train_g2p": True,
                       "g2p_steps": pick(1200, 120), "g2p_ensemble": pick(3, 1)},
        "batch": {"size": pick(48, 2)},
        "trainer": {"max_steps": pick(500000, 10), "log_every": pick(100, 5),
                    "val_every": pick(2000, 1000000000), "ckpt_every": pick(10000, 10)},
        "data_loaders": {"n_workers": pick(4, 1), "prefetch_factor": pick(16, 2)},
        "optimizer": {"method": "adamw", "lr": pick(0.0002, 0.001),
                      "lr_schedule": "WarmupCosine",
                      "lr_schedule_kwargs": {"warmup_steps": pick(4000, 2),
                                             "decay_steps": pick(500000, 100)},
                      "grad_clip": 1.0, "weight_decay": 0.000001},
        "loss": {"spectral_kind": "l1", "spectral_scale": 1.0, "gate_scale": 1.0,
                 "variance_scales": {"durations": 0.1, "aggregate_pitch": 0.1,
                                     "aggregate_energy": 0.1}},
    }


# configs/tts_model.yml, the sections other than "model", per value_select
TTS_TRAIN_PRESETS: tp.Dict[str, dict] = {"default": _train_preset(False),
                                         "debug": _train_preset(True)}


def _data_preset(debug: bool) -> dict:
    def pick(default, dbg):
        return dbg if debug else default

    return {
        "dirs": {"data_root": str(REPO / "tests" / "data" / "SEGS")},
        "file_search": {"ext": ".TextGridStage3"},
        "dataset": {"subsets": ["train", "test"], "split_ratio": pick(0.8, 0.5),
                    "max_num_samples": pick(None, 6), "seed": 0},
        "parser": {"type": "TTSDSParser", "max_duration": 10.0, "min_duration": 0.5,
                   "audio_strip": False},
        "preproc": {
            "pipe": ["load_audio", "volume_normalize", "multiple_audio", "magnitude",
                     "linear_to_mel", "amp_to_db", "normalize_mel", "energy", "pitch",
                     "add_pauses_from_timestamps", "text_to_transcription", "add_ling_feat",
                     "add_lm_feat", "add_xpbert_feat", "calc_durations", "aggregate_pitch",
                     "aggregate_energy", "gate_target"],
            "pipe_cfg": {"load_audio": {"sample_rate": 24000}, "multiple_audio": {"hop": 256},
                         "magnitude": {"n_fft": 1024, "hop_len": 256},
                         "linear_to_mel": {"n_mels": pick(100, 80)},
                         "pitch": {"f0_min": 80.0, "f0_max": 880.0}},
        },
        "singleton_handlers": ["SpeakerIDSetter", "StatisticsRange", "DatasetStatistics",
                               "PhonemeStatistics"],
        "collate": {"type": "TTSCollate", "token_multiple": pick(16, 128),
                    "frame_multiple": pick(64, 1024), "sample_multiple": pick(256, 262144)},
        "processor": {},
        "sampler": {"train": {"type": "RandomSampler", "comb_by_len": True},
                    "test": {"type": "SimpleSampler"}},
        "data_server": {"n_workers": pick(2, 1)},
    }


# configs/tts_data_24khz.yml, per value_select; data_root is this checkout's
# tests/data/SEGS, the corpus the YAML names
TTS_DATA_PRESETS: tp.Dict[str, dict] = {"default": _data_preset(False),
                                        "debug": _data_preset(True)}


# the model configs of the repository the port carries: (the sections other than
# "model", the model section), per value_select
RECIPES: tp.Dict[str, tp.Tuple[tp.Dict[str, dict], tp.Dict[str, dict]]] = {
    "configs/tts_model.yml": (TTS_TRAIN_PRESETS, TTS_MODEL_PRESETS),
    "configs/xtts_model.yml": (XTTS_TRAIN_PRESETS, XTTS_MODEL_PRESETS),
}
DATA_CONFIG = "configs/tts_data_24khz.yml"


def recipe_of(path: tp.Union[str, Path], known: tp.Iterable[str] = RECIPES) -> str:
    """The repository config (a key of ``RECIPES``, or ``known``) that ``path``
    names, relative to the repository or as a path on disk; ``NotImplementedError``
    for any other file, which would need the YAML reader."""
    p = Path(path)
    for name in known:
        if p.as_posix() == name or p.resolve() == (REPO / name).resolve():
            return name
    raise NotImplementedError(f"{path}: the port carries only {sorted(known)} as presets; "
                              "reading another YAML config is not ported yet")


def configs(value_select: str = "default", recipe: str = "configs/tts_model.yml"
            ) -> tp.Tuple[dict, dict]:
    """(model config, data config) of ``recipe`` (a key of ``RECIPES``) with the
    data config of ``tts_data_24khz.yml``: fresh copies."""
    train_presets, model_presets = RECIPES[recipe]
    model_cfg = copy.deepcopy(train_presets[value_select])
    model_cfg["model"] = copy.deepcopy(model_presets[value_select])
    return model_cfg, copy.deepcopy(TTS_DATA_PRESETS[value_select])


def _train_g2p(model_cfg: tp.Mapping, data_cfg: tp.Mapping, saver: ExperimentSaver) -> None:
    """The experiment's raw-text G2P, as the JAX script trains it; a failure is
    logged and training goes on."""
    exp = model_cfg.get("experiment") or {}
    if not exp.get("train_g2p", True):
        return
    try:
        from speechflow_torch.scripts.train_g2p import train_g2p_artifact

        train_g2p_artifact((data_cfg.get("dirs") or {}).get("data_root"),
                           saver.expr_path / "g2p.pkl",
                           steps=int(exp.get("g2p_steps", 1200)),
                           ensemble=int(exp.get("g2p_ensemble", 3)))
    except Exception as e:  # a G2P failure never stops the acoustic model's training
        LOGGER.warning("G2P training skipped: %r", e)


def data_config_of(model_cfg: tp.Mapping, data_cfg: tp.Mapping) -> tp.Mapping:
    """``data_cfg`` as the model trains on it: a prompt-conditioned XTTS trains on
    same-speaker prompt pairs, so its ``TTSCollate`` becomes
    ``TTSCollateWithPrompt`` (in a copy); any other config is returned as given."""
    m_cfg = model_cfg.get("model") or {}
    if (m_cfg.get("type") == "xtts" and m_cfg.get("use_prompt")
            and (data_cfg.get("collate") or {}).get("type") == "TTSCollate"):
        data_cfg = copy.deepcopy(dict(data_cfg))
        data_cfg["collate"]["type"] = "TTSCollateWithPrompt"
    return data_cfg


def build_model(model_cfg: tp.Mapping, pipeline) -> tp.Tuple[tp.Any, tp.Any, tp.Callable,
                                                              tp.Callable]:
    """(params, model, criterion, batch processor) of the model config's type,
    sized from ``pipeline``; the model on the CPU, from torch's global generator."""
    m_dict = model_config_from_info(model_cfg, pipeline)
    model_type = m_dict.pop("type", "parallel")
    if model_type == "xtts":
        m_dict.pop("n_langs", None)  # XTTS conditions on the speaker only
        # the mel bins size the prompt encoder; the GPT's targets are codec codes
        n_mels = m_dict.pop("n_mels", None)
        if m_dict.get("use_prompt") and n_mels and "prompt_dim" not in m_dict:
            m_dict["prompt_dim"] = int(n_mels)
        params = XTTSParams.create(m_dict)
        return params, XTTSModel(params), xtts_criterion(), XTTSBatchProcessor()
    if model_type != "parallel":
        raise ValueError(f"unknown model type {model_type!r} (parallel or xtts)")
    params = ParallelTTSParams.create(m_dict)
    criterion = TTSCriterion(**filter_kwargs(TTSCriterion.__init__,
                                             dict(model_cfg.get("loss") or {})))
    return params, ParallelTTSModel(params), criterion, TTSBatchProcessor()


def train(model_cfg: tp.Mapping, data_cfg: tp.Mapping, saver: ExperimentSaver,
          device: tp.Union[str, torch.device, None] = None,
          callbacks: tp.Sequence[tp.Callable] = (),
          tb_dir: tp.Optional[tp.Union[str, Path]] = None) -> str:
    """Build and fit the acoustic model; returns the experiment directory.
    Scalars go to TensorBoard under ``tb_dir`` when one is given."""
    dev = resolve_device(device)
    data_cfg = data_config_of(model_cfg, data_cfg)
    cfg = trainer_config(model_cfg)
    torch.manual_seed(cfg.seed)
    pipeline, loaders = build_data(data_cfg, model_cfg)
    try:
        params, model, criterion, batch_processor = build_model(model_cfg, pipeline)
        model = model.to(dev)
        saver.to_save["pipeline_info"] = pipeline.get_info()
        saver.to_save["model_params"] = dataclasses.asdict(params)
        _train_g2p(model_cfg, data_cfg, saver)
        trainer = Trainer(model, criterion, batch_processor, optimizer_config(model_cfg), cfg,
                          saver=saver, tb_dir=tb_dir)
        apply_resume_warmstart(trainer, model_cfg)
        last = trainer.fit(loaders["train"], loaders.get("test"), callbacks=callbacks)
        LOGGER.info("training done: %s", last)
        return str(saver.expr_path)
    finally:
        for ld in loaders.values():
            ld.close()


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="training of the acoustic model")
    ap.add_argument("-c", "--model_config", default="configs/tts_model.yml",
                    help=f"one of {sorted(RECIPES)}")
    ap.add_argument("-cd", "--data_config", default=DATA_CONFIG, help=DATA_CONFIG)
    ap.add_argument("-vs", "--value_select", default="default", choices=["default", "debug"])
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--experiment_dir", default=None)
    ap.add_argument("-r", "--resume_from", default=None)
    ap.add_argument("-w", "--warmstart", default=None, help="warmstart.ckpt")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU")
    ap.add_argument("--tb", action="store_true", help="TensorBoard scalars in <experiment>/tb")
    args = ap.parse_args(argv)
    recipe_of(args.data_config, known=(DATA_CONFIG,))
    model_cfg, data_cfg = configs(args.value_select, recipe_of(args.model_config))
    if args.data_root:
        data_cfg["dirs"]["data_root"] = args.data_root
    if args.max_steps:
        model_cfg["trainer"]["max_steps"] = args.max_steps
    if args.resume_from:
        model_cfg["resume"] = {"from": args.resume_from}
    if args.warmstart:
        model_cfg.setdefault("warmstart", {})["ckpt"] = args.warmstart
    saver = experiment_saver(model_cfg, data_cfg, args.experiment_dir)
    return train(model_cfg, data_cfg, saver, device=args.device,
                 tb_dir=saver.expr_path / "tb" if args.tb else None)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
