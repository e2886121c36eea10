"""What the training entry points share (counterpart of the parts of
``speechflow_tpu/scripts/common.py`` the vocoder and TTS scripts use): the
experiment directory with its configs, the data pipeline and its loaders,
the optimizer and trainer configs read from a model config, the model
params sized from the pipeline (``model_config_from_info``), and the
resume / finetune / warm-start wiring (``apply_resume_warmstart``).

Configs are plain nested dicts (the sections of the YAML files, one
``value_select`` resolved): the machine with the GPU has no YAML reader, so
the port's scripts carry them as presets. A config's text is written as
JSON, which YAML readers also read.
"""

from __future__ import annotations

import copy
import json
import logging
import typing as tp
from pathlib import Path

from speechflow_torch.convert import load_nnx_state, nnx_from_module
from speechflow_torch.data.core.components import AudioLoader, DataPipeline
from speechflow_torch.training.optimizer import OptimizerConfig
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.training.trainer import TrainerConfig

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["experiment_saver", "source_checkpoint", "resume_singletons", "build_data",
           "model_config_from_info", "trainer_config",
           "optimizer_config", "apply_resume_warmstart", "XTTS_MODEL_PRESETS",
           "XTTS_TRAIN_PRESETS"]


def _xtts_model(debug: bool) -> dict:
    def pick(default, dbg):
        return dbg if debug else default

    return {
        "type": "xtts", "dim": pick(1024, 48), "n_layers": pick(12, 1),
        "n_heads": pick(8, 2), "block_type": "attention",
        "speaker_emb_dim": pick(128, 16), "use_prompt": True,
        "prompt_layers": pick(4, 1), "prompt_downsample": 4,
        "prompt_max_frames": pick(448, 64), "freeze_codec": False,
        "codec": {"sample_rate": 24000, "channels": pick(32, 8),
                  "latent_dim": pick(64, 16), "strides": [4, 8, 8],
                  "n_quantizers": pick(4, 2), "codebook_size": pick(1024, 64)},
    }


# configs/xtts_model.yml, section "model", per value_select (``XTTSParams``; the
# prompt encoder's heads are XTTSParams' default 4, 256 wide at dim 1024)
XTTS_MODEL_PRESETS: tp.Dict[str, dict] = {"default": _xtts_model(False),
                                          "debug": _xtts_model(True)}


def _xtts_train(debug: bool) -> dict:
    def pick(default, dbg):
        return dbg if debug else default

    return {
        "experiment": {"name": "xtts_gpt", "base_dir": "experiments",
                       "g2p_steps": pick(600, 120)},
        "batch": {"size": pick(32, 2)},
        "trainer": {"max_steps": pick(1000000, 6), "log_every": pick(100, 2),
                    "ckpt_every": pick(20000, 6)},
        "data_loaders": {"n_workers": pick(2, 1), "prefetch_factor": pick(8, 2)},
        "optimizer": {"method": "adamw", "lr": pick(0.0001, 0.001),
                      "lr_schedule": "WarmupCosine",
                      "lr_schedule_kwargs": {"warmup_steps": pick(4000, 2),
                                             "decay_steps": pick(1000000, 100)},
                      "grad_clip": 1.0},
        "loss": {},
    }


# configs/xtts_model.yml, the sections other than "model", per value_select
XTTS_TRAIN_PRESETS: tp.Dict[str, dict] = {"default": _xtts_train(False),
                                          "debug": _xtts_train(True)}


def experiment_saver(model_cfg: tp.Mapping, data_cfg: tp.Mapping,
                     base_dir: tp.Optional[tp.Union[str, Path]] = None) -> ExperimentSaver:
    """A new experiment directory under ``base_dir`` (else the config's
    ``experiment.base_dir``), named after ``experiment.name``, with both
    configs' text written beside the checkpoints and into the payload."""
    exp = model_cfg.get("experiment") or {}
    saver = ExperimentSaver(base_dir or exp.get("base_dir", "experiments"),
                            expr_suffix=exp.get("name", "run"))
    saver.save_configs(data_cfg_text=json.dumps(data_cfg, indent=2),
                       model_cfg_text=json.dumps(model_cfg, indent=2))
    return saver


def source_checkpoint(model_cfg: tp.Mapping) -> tp.Tuple[tp.Optional[str], tp.Optional[Path]]:
    """(kind, checkpoint) the model config starts from: ``("resume", the last
    checkpoint under resume.from)``, ``("finetune", finetune.ckpt)``,
    ``("warmstart", warmstart.ckpt)`` or ``(None, None)`` for a fresh start.
    ``FileNotFoundError`` if the checkpoint is missing."""
    resume_from = (model_cfg.get("resume") or {}).get("from")
    if resume_from:
        ckpt = ExperimentSaver.get_last_checkpoint(resume_from)
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint under {resume_from}")
        return "resume", ckpt
    for kind in ("finetune", "warmstart"):
        src = (model_cfg.get(kind) or {}).get("ckpt")
        if src:
            if not (Path(src) / "model.npz").exists():
                raise FileNotFoundError(f"{kind}.ckpt {src} is not a checkpoint of the port")
            return kind, Path(src)
    return None, None


def resume_singletons(model_cfg: tp.Mapping) -> tp.Optional[dict]:
    """The singleton handlers' state of the checkpoint the model config starts
    from (``source_checkpoint``), None for a fresh start: the data pipeline
    seeds its handlers with it, so the checkpoint's speaker and language ids,
    and with them its embedding rows, stay those speakers' on another corpus."""
    ckpt = source_checkpoint(model_cfg)[1]
    if ckpt is None:
        return None
    return (ExperimentSaver.load_payload(ckpt).get("pipeline_info") or {}).get("singletons")


def build_data(data_cfg: tp.Mapping, model_cfg: tp.Mapping
               ) -> tp.Tuple[DataPipeline, tp.Dict[str, AudioLoader]]:
    """The pipeline of the data config, its singleton handlers seeded from the
    checkpoint the model config starts from (``resume_singletons``), and a
    loader per subset at the model config's ``batch.size``, with
    ``data_loaders.n_workers`` and ``prefetch_factor``."""
    dl = model_cfg.get("data_loaders") or {}
    batch_size = int((model_cfg.get("batch") or {}).get("size", 8))
    pipeline = DataPipeline.from_config(data_cfg, seed_singletons=resume_singletons(model_cfg))
    loaders = {}
    try:
        for subset in pipeline.samplers:
            loaders[subset] = pipeline.loader(subset, batch_size,
                                              n_workers=int(dl.get("n_workers", 2)),
                                              prefetch_factor=int(dl.get("prefetch_factor", 8)))
    except BaseException:
        for ld in loaders.values():
            ld.close()
        raise
    return pipeline, loaders


def model_config_from_info(model_cfg: tp.Mapping, pipeline: DataPipeline) -> dict:
    """The model section with the dimensions the data decides: ``n_symbols``
    (the alphabet), ``n_speakers`` and ``n_langs`` (``SpeakerIDSetter``, at
    least 1 each) and ``n_mels`` (the ``linear_to_mel`` handler's)."""
    info = pipeline.get_info()
    m = copy.deepcopy(dict(model_cfg.get("model") or {}))
    if pipeline.alphabet is not None:
        m["n_symbols"] = len(pipeline.alphabet)
    spk = (info.get("singletons") or {}).get("SpeakerIDSetter", {})
    m["n_speakers"] = max(len(spk.get("speaker2id", {})), 1)
    m["n_langs"] = max(len(spk.get("lang2id", {})), 1)
    pipe_cfg = (info["config"].get("preproc") or {}).get("pipe_cfg") or {}
    n_mels = (pipe_cfg.get("linear_to_mel") or {}).get("n_mels")
    if n_mels:
        m["n_mels"] = int(n_mels)
    return m


def trainer_config(model_cfg: tp.Mapping) -> TrainerConfig:
    t = dict(model_cfg.get("trainer") or {})
    known = {"max_steps", "log_every", "val_every", "ckpt_every", "val_batches", "seed"}
    kwargs: tp.Dict[str, tp.Any] = {k: int(v) for k, v in t.items() if k in known}
    for flag in ("use_mesh", "mixed_precision"):
        if flag in t:
            kwargs[flag] = bool(t[flag])
    return TrainerConfig(**kwargs)


def optimizer_config(model_cfg: tp.Mapping, section: str = "optimizer") -> OptimizerConfig:
    return OptimizerConfig.from_config(model_cfg.get(section) or {})


def apply_resume_warmstart(trainer, model_cfg: tp.Mapping) -> None:
    """The model config's start (``source_checkpoint``), from the port's own
    checkpoints:

    - ``resume.from`` (an experiment or checkpoint directory): the last
      checkpoint's weights, optimizer state and step;
    - ``finetune.ckpt`` (a checkpoint directory): its weights only (a fresh
      optimizer and step 0);
    - ``warmstart.ckpt`` (a checkpoint directory) with ``include`` / ``exclude``
      lists of path prefixes (``ExperimentSaver.filter_state_by_prefix``): the
      selected weights of the same shape over the fresh model's, the rest left
      as initialised.
    """
    kind, ckpt = source_checkpoint(model_cfg)
    if kind is None:
        return
    if kind == "resume":
        trainer.load_checkpoint(ckpt)
        LOGGER.info("resumed from %s at step %d", ckpt, trainer.global_step)
        return
    source = ExperimentSaver.load_checkpoint(ckpt)[0]["model"]
    if kind == "warmstart":
        ws_cfg = model_cfg["warmstart"]
        source = ExperimentSaver.filter_state_by_prefix(
            source, include=ws_cfg.get("include") or [], exclude=ws_cfg.get("exclude") or [])
    merged = ExperimentSaver.merge_states(nnx_from_module(trainer.model), source)
    load_nnx_state(trainer.model, merged)
    LOGGER.info("%s weights loaded from %s", kind, ckpt)
