"""Forced-aligner training (counterpart of ``speechflow_tpu/scripts/train_aligner.py``).

The two-stage recipe: stage 1 (``configs/aligner_data_stage1.yml``) trains on
the seg generator's raw ``.TextGrid`` files with pauses from the text; the
annotator's ``Aligner`` (``annotator/align.py``) then writes
``.TextGridStage1``, on which stage 2 (``configs/aligner_data_stage2.yml``,
pauses from the timestamps) trains, and so on. The model is sized from the
pipeline (``model_config_from_info``); checkpoints carry the pipeline info and
the model params, which the ``Aligner`` rebuilds its data path from.

    python -m speechflow_torch.scripts.train_aligner -vs debug --device cpu --max_steps 4
    python -m speechflow_torch.scripts.train_aligner -cd configs/aligner_data_stage2.yml \\
        --data_root <dir of .TextGridStage1 files>                         # on the GPU

It runs on the GPU unless ``device="cpu"``. Weights start from
``torch.manual_seed(trainer.seed)``; ``-r``, ``finetune.ckpt`` and ``-w`` read
checkpoints of either package (``common.apply_resume_warmstart``).
"""

from __future__ import annotations

import dataclasses
import logging
import typing as tp
from pathlib import Path

import torch

from speechflow_torch.models.aligner import (
    AlignerBatchProcessor,
    AlignerCriterion,
    GlowTTSAligner,
    GlowTTSParams,
)
from speechflow_torch.scripts.common import (
    apply_resume_warmstart,
    build_data,
    close_data,
    configs_of_args,
    experiment_saver,
    model_config_from_info,
    optimizer_config,
    read_configs,
    train_arguments,
    trainer_config,
)
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.training.trainer import Trainer
from speechflow_torch.utils.device import resolve_device

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["MODEL_CONFIG", "DATA_CONFIG", "configs", "train", "main"]

MODEL_CONFIG = "configs/aligner_model.yml"
DATA_CONFIG = "configs/aligner_data_stage1.yml"


def configs(value_select: tp.Union[str, tp.Sequence[str], None] = "default",
            model_config: tp.Union[str, Path] = MODEL_CONFIG,
            data_config: tp.Union[str, Path] = DATA_CONFIG,
            data_root: tp.Union[str, Path, None] = None) -> tp.Tuple[dict, dict]:
    """(model config, data config) read from the YAML files (stage 1 by
    default) with ``value_select``: fresh dicts."""
    return read_configs(model_config, data_config, value_select, data_root)


def train(model_cfg: tp.Mapping, data_cfg: tp.Mapping, saver: ExperimentSaver,
          device: tp.Union[str, torch.device, None] = None,
          callbacks: tp.Sequence[tp.Callable] = (),
          tb_dir: tp.Optional[tp.Union[str, Path]] = None) -> str:
    """Build and fit the aligner; returns the experiment directory."""
    dev = resolve_device(device)
    cfg = trainer_config(model_cfg)
    pipeline, loaders = build_data(data_cfg, model_cfg)
    try:
        params = GlowTTSParams.create(model_config_from_info(model_cfg, pipeline))
        torch.manual_seed(cfg.seed)
        model = GlowTTSAligner(params).to(dev)
        criterion = AlignerCriterion(
            duration_scale=float((model_cfg.get("loss") or {}).get("duration_scale", 1.0)))
        saver.to_save["pipeline_info"] = pipeline.get_info()
        saver.to_save["model_params"] = dataclasses.asdict(params)
        trainer = Trainer(model, criterion, AlignerBatchProcessor(),
                          optimizer_config(model_cfg), cfg, saver=saver, tb_dir=tb_dir)
        apply_resume_warmstart(trainer, model_cfg)
        last = trainer.fit(loaders["train"], callbacks=callbacks)
        LOGGER.info("aligner training done: %s", last)
        return str(saver.expr_path)
    finally:
        close_data(loaders)


def main(argv=None) -> str:
    args = train_arguments("training of the forced aligner", MODEL_CONFIG,
                           DATA_CONFIG).parse_args(argv)
    model_cfg, data_cfg = configs_of_args(args)
    saver = experiment_saver(model_cfg, data_cfg, args.experiment_dir)
    return train(model_cfg, data_cfg, saver, device=args.device,
                 tb_dir=saver.expr_path / "tb" if args.tb else None)


def cli() -> None:
    """Console entry point: exit-code semantics want None."""
    main()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
