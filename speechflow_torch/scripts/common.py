"""What the training entry points share (counterpart of the parts of
``speechflow_tpu/scripts/common.py`` the vocoder and TTS scripts use): the
experiment directory with its configs, the data pipeline and its loaders,
the optimizer and trainer configs read from a model config, and the model
params sized from the pipeline (``model_config_from_info``).

Configs are plain nested dicts (the sections of the YAML files, one
``value_select`` resolved): the machine with the GPU has no YAML reader, so
the port's scripts carry them as presets. A config's text is written as
JSON, which YAML readers also read.
"""

from __future__ import annotations

import copy
import json
import typing as tp
from pathlib import Path

from speechflow_torch.data.core.components import AudioLoader, DataPipeline
from speechflow_torch.training.optimizer import OptimizerConfig
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.training.trainer import TrainerConfig

__all__ = ["experiment_saver", "build_data", "model_config_from_info", "trainer_config",
           "optimizer_config", "XTTS_MODEL_PRESETS"]


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


def build_data(data_cfg: tp.Mapping, model_cfg: tp.Mapping
               ) -> tp.Tuple[DataPipeline, tp.Dict[str, AudioLoader]]:
    """The pipeline of the data config and a loader per subset at the model
    config's ``batch.size``, with ``data_loaders.n_workers`` and
    ``prefetch_factor``."""
    dl = model_cfg.get("data_loaders") or {}
    batch_size = int((model_cfg.get("batch") or {}).get("size", 8))
    pipeline = DataPipeline.from_config(data_cfg)
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
