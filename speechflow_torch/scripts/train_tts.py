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

``-c`` and ``-cd`` read any YAML model and data config (``io.config``;
defaults ``configs/tts_model.yml`` and ``configs/tts_data_24khz.yml``),
``-vs`` takes the selectors of their ``value_select``, and ``--data_root``
replaces the data config's ``dirs.data_root``; the experiment directory gets
both configs' YAML text.

    python -m speechflow_torch.scripts.train_tts -vs debug --device cpu --max_steps 4
    python -m speechflow_torch.scripts.train_tts -c configs/xtts_model.yml -vs debug \
        --device cpu --max_steps 2
    python -m speechflow_torch.scripts.train_tts -c configs/xtts_model.yml   # on the GPU
    python -m speechflow_torch.scripts.train_tts -c configs/tts_forward.yml  # on the GPU

It runs on the GPU unless ``device="cpu"``. Weights start from
``torch.manual_seed(trainer.seed)``; ``resume.from`` (``-r``),
``finetune.ckpt`` and ``warmstart.ckpt`` (``-w``, with ``include`` /
``exclude``) read checkpoints of either package; ``-r`` of a JAX checkpoint
resumes its optax state too (``common.apply_resume_warmstart``).
Every experiment trains a G2P into its directory as ``g2p.pkl`` (as the JAX
script does: ``experiment.train_g2p``, ``g2p_steps``, ``g2p_ensemble``; on the
training device), inside a guard that logs a failure and goes on; the eval
interfaces find it there and phonemize raw text through it.
"""

from __future__ import annotations

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
from speechflow_torch.parallel.distributed import init_distributed, shutdown_distributed
from speechflow_torch.scripts.common import (
    apply_resume_warmstart,
    build_data,
    close_data,
    configs_of_args,
    data_parallel_ranks,
    experiment_log,
    experiment_saver,
    model_config_from_info,
    optimizer_config,
    rank_experiment,
    read_configs,
    train_arguments,
    trainer_config,
)
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.training.trainer import Trainer
from speechflow_torch.utils.device import resolve_device
from speechflow_torch.utils.init import filter_kwargs

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["MODEL_CONFIG", "DATA_CONFIG", "configs", "data_config_of", "build_model",
           "train", "main"]

MODEL_CONFIG = "configs/tts_model.yml"
DATA_CONFIG = "configs/tts_data_24khz.yml"


def configs(value_select: tp.Union[str, tp.Sequence[str], None] = "default",
            model_config: tp.Union[str, Path] = MODEL_CONFIG,
            data_config: tp.Union[str, Path] = DATA_CONFIG,
            data_root: tp.Union[str, Path, None] = None) -> tp.Tuple[dict, dict]:
    """(model config, data config) read from the YAML files (the repository's
    recipe by default) with ``value_select``: fresh dicts."""
    return read_configs(model_config, data_config, value_select, data_root)


def _train_g2p(model_cfg: tp.Mapping, data_cfg: tp.Mapping, saver: ExperimentSaver,
               device: torch.device) -> None:
    """The experiment's raw-text G2P, as the JAX script trains it, on ``device``;
    a failure is logged and training goes on."""
    exp = model_cfg.get("experiment") or {}
    if not exp.get("train_g2p", True):
        return
    try:
        from speechflow_torch.scripts.train_g2p import train_g2p_artifact

        train_g2p_artifact((data_cfg.get("dirs") or {}).get("data_root"),
                           saver.expr_path / "g2p.pkl",
                           steps=int(exp.get("g2p_steps", 1200)),
                           ensemble=int(exp.get("g2p_ensemble", 3)), device=device)
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
    sized from ``pipeline``; the model on torch's default device, from torch's
    global generator."""
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


def train(model_cfg: tp.Mapping, data_cfg: tp.Mapping, saver: tp.Optional[ExperimentSaver],
          device: tp.Union[str, torch.device, None] = None,
          callbacks: tp.Sequence[tp.Callable] = (),
          tb_dir: tp.Optional[tp.Union[str, Path]] = None) -> str:
    """Build and fit the acoustic model; returns the experiment directory.
    Scalars go to TensorBoard under ``tb_dir`` when one is given.

    As one rank of a data-parallel run (the environment contract of
    ``parallel.init_distributed``, which this joins; ``trainer.use_mesh``):
    ``batch.size`` is the global batch, rank 0's data server feeds every rank
    (``build_data``), rank 0 alone passes a saver and trains the G2P, and every
    rank returns rank 0's experiment directory."""
    dev = resolve_device(device)
    init_distributed(device=dev)
    data_cfg = data_config_of(model_cfg, data_cfg)
    cfg = trainer_config(model_cfg)
    data_parallel_ranks(cfg)
    torch.manual_seed(cfg.seed)
    pipeline, loaders = build_data(data_cfg, model_cfg)
    try:
        with dev:  # initialised on the device it trains on (seconds on a host's CPU)
            params, model, criterion, batch_processor = build_model(model_cfg, pipeline)
        model = model.to(dev)
        if saver is not None:
            saver.to_save["pipeline_info"] = pipeline.get_info()
            saver.to_save["model_params"] = dataclasses.asdict(params)
            _train_g2p(model_cfg, data_cfg, saver, dev)
        trainer = Trainer(model, criterion, batch_processor, optimizer_config(model_cfg), cfg,
                          saver=saver, tb_dir=tb_dir)
        apply_resume_warmstart(trainer, model_cfg)
        last = trainer.fit(loaders["train"], loaders.get("test"), callbacks=callbacks)
        LOGGER.info("training done: %s", last)
        return rank_experiment(saver)
    finally:
        close_data(loaders)


def main(argv=None) -> str:
    args = train_arguments("training of the acoustic model", MODEL_CONFIG,
                           DATA_CONFIG).parse_args(argv)
    model_cfg, data_cfg = configs_of_args(args)
    rank, world = init_distributed(device=args.device)
    saver = experiment_saver(model_cfg, data_cfg, args.experiment_dir) if rank == 0 else None
    try:
        with experiment_log(saver):
            return train(model_cfg, data_cfg, saver, device=args.device,
                         tb_dir=saver.expr_path / "tb" if args.tb and saver else None)
    finally:
        if world > 1:
            shutdown_distributed()


def cli() -> None:
    """Console entry point: exit-code semantics want None."""
    main()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
