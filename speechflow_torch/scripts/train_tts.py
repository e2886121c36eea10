"""Acoustic-model training (counterpart of ``speechflow_tpu/scripts/train_tts.py``,
its ``parallel`` branch).

Builds the data (``configs/tts_data_24khz.yml``: TextGrid files -> mel,
pitch, energy, durations and the text features), sizes ``ParallelTTSModel``
from the pipeline (``model_config_from_info``), builds ``TTSCriterion`` and
``Trainer`` and ``fit``s, with checkpoints that carry the pipeline info and
the model params, which ``TTSEvaluationInterface.from_checkpoint`` rebuilds
the text path and the model from. The configs are the presets below,
transcribed from ``configs/tts_model.yml`` and ``configs/tts_data_24khz.yml``
per ``value_select`` (a CPU test holds them equal to the YAML files); the
model section is ``serving.TTS_MODEL_PRESETS``.

    python -m speechflow_torch.scripts.train_tts -vs debug --device cpu --max_steps 4
    python -m speechflow_torch.scripts.train_tts --max_steps 8   # on the GPU

It runs on the GPU unless ``device="cpu"``. Weights start from
``torch.manual_seed(trainer.seed)``; ``resume.from`` reads the port's own
checkpoints. Every experiment tries to train a G2P into its directory, as
the JAX script does, inside a guard that logs a failure and goes on: the
G2P trainer (``scripts/train_g2p.py``) is not ported yet, so the guard logs
that and the eval interface uses the char fallback. Not ported, and raising
``NotImplementedError``: the ``xtts`` model type, ``finetune.ckpt`` and
``warmstart.ckpt``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import logging
import typing as tp
from pathlib import Path

import torch

from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams, TTSCriterion
from speechflow_torch.models.tts.batch_processor import TTSBatchProcessor
from speechflow_torch.scripts.common import (
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

__all__ = ["TTS_TRAIN_PRESETS", "TTS_DATA_PRESETS", "configs", "train", "main"]

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


def configs(value_select: str = "default") -> tp.Tuple[dict, dict]:
    """(model config, data config) of the acoustic-model recipe: fresh copies."""
    model_cfg = copy.deepcopy(TTS_TRAIN_PRESETS[value_select])
    model_cfg["model"] = copy.deepcopy(TTS_MODEL_PRESETS[value_select])
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


def train(model_cfg: tp.Mapping, data_cfg: tp.Mapping, saver: ExperimentSaver,
          device: tp.Union[str, torch.device, None] = None,
          callbacks: tp.Sequence[tp.Callable] = (),
          tb_dir: tp.Optional[tp.Union[str, Path]] = None) -> str:
    """Build and fit the acoustic model; returns the experiment directory.
    Scalars go to TensorBoard under ``tb_dir`` when one is given."""
    dev = resolve_device(device)
    model_type = (model_cfg.get("model") or {}).get("type", "parallel")
    if model_type != "parallel":
        raise NotImplementedError(f"model type {model_type!r} (models/tts/xtts.py) is not "
                                  "ported yet")
    for key in ("finetune", "warmstart"):
        if (model_cfg.get(key) or {}).get("ckpt"):
            raise NotImplementedError(f"{key}.ckpt is not ported yet")
    cfg = trainer_config(model_cfg)
    torch.manual_seed(cfg.seed)
    pipeline, loaders = build_data(data_cfg, model_cfg)
    try:
        params = ParallelTTSParams.create(model_config_from_info(model_cfg, pipeline))
        model = ParallelTTSModel(params).to(dev)
        criterion = TTSCriterion(**filter_kwargs(TTSCriterion.__init__,
                                                 dict(model_cfg.get("loss") or {})))
        saver.to_save["pipeline_info"] = pipeline.get_info()
        saver.to_save["model_params"] = dataclasses.asdict(params)
        _train_g2p(model_cfg, data_cfg, saver)
        trainer = Trainer(model, criterion, TTSBatchProcessor(),
                          optimizer_config(model_cfg), cfg, saver=saver, tb_dir=tb_dir)
        resume_from = (model_cfg.get("resume") or {}).get("from")
        if resume_from:
            ckpt = ExperimentSaver.get_last_checkpoint(resume_from)
            if ckpt is None:
                raise FileNotFoundError(f"no checkpoint under {resume_from}")
            trainer.load_checkpoint(ckpt)
            LOGGER.info("resumed from %s at step %d", ckpt, trainer.global_step)
        last = trainer.fit(loaders["train"], loaders.get("test"), callbacks=callbacks)
        LOGGER.info("training done: %s", last)
        return str(saver.expr_path)
    finally:
        for ld in loaders.values():
            ld.close()


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="training of the acoustic model")
    ap.add_argument("-vs", "--value_select", default="default", choices=["default", "debug"])
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--experiment_dir", default=None)
    ap.add_argument("-r", "--resume_from", default=None)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU")
    ap.add_argument("--tb", action="store_true", help="TensorBoard scalars in <experiment>/tb")
    args = ap.parse_args(argv)
    model_cfg, data_cfg = configs(args.value_select)
    if args.data_root:
        data_cfg["dirs"]["data_root"] = args.data_root
    if args.max_steps:
        model_cfg["trainer"]["max_steps"] = args.max_steps
    if args.resume_from:
        model_cfg["resume"] = {"from": args.resume_from}
    saver = experiment_saver(model_cfg, data_cfg, args.experiment_dir)
    return train(model_cfg, data_cfg, saver, device=args.device,
                 tb_dir=saver.expr_path / "tb" if args.tb else None)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
