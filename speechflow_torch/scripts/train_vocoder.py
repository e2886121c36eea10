"""Vocoder (GAN) training (counterpart of ``speechflow_tpu/scripts/train_vocoder.py``).

Builds the data, the Vocos generator, the ``VocoderDiscriminator``, both
criteria and ``GANTrainer``, then ``fit``s. ``-c`` and ``-cd`` read any YAML
model and data config (defaults ``configs/vocoder_bigvgan.yml``, BigVGAN
head, and ``configs/vocoder_data_24khz.yml``; ``configs/vocoder_model.yml`` is
the Vocos/ISTFT recipe), ``-vs`` takes the selectors of their
``value_select``; the flags are those of JAX's script.

    python -m speechflow_torch.scripts.train_vocoder -vs debug --device cpu
    python -m speechflow_torch.scripts.train_vocoder -c configs/vocoder_model.yml  # GPU

It runs on the GPU unless ``device="cpu"``. Weights start from
``torch.manual_seed(trainer.seed)``. ``resume.from`` (``-r``, either package's
checkpoints, both optimizers' states) and ``warmstart.disc_from`` (either
package's) are read; ``-w`` sets
``warmstart.ckpt``, which this script, like JAX's, does not read, and so is
``gan.mos_ckpt``: the JAX trainer takes a MOS model only through
``GANTrainer(mos_hook=...)`` (``models/vocoder/mos_proxy.py``). The ``tts``
feature extractor (E2E GAN-TTS, ``configs/vocoder_styletts2_e2e*.yml`` over
``configs/tts_data_24khz.yml``) sizes the acoustic model from the pipeline and
batches through ``E2EBatchProcessor``; ``loss.bio_ckpt`` adds the
speaker-similarity loss and ``loss.cpc_ckpt`` the CPC perceptual loss (a
``save_module`` pickle of a ``CPCModel``, frozen).
"""

from __future__ import annotations

import dataclasses
import logging
import typing as tp
from pathlib import Path

import torch

from speechflow_torch.models.vocoder import Vocos, VocosParams
from speechflow_torch.models.vocoder.batch_processor import VocoderBatchProcessor
from speechflow_torch.models.vocoder.criterion import (
    vocoder_disc_criterion,
    vocoder_gen_criterion,
)
from speechflow_torch.models.vocoder.discriminators import VocoderDiscriminator
from speechflow_torch.models.vocoder.tts_features import E2EBatchProcessor
from speechflow_torch.parallel.distributed import init_distributed, shutdown_distributed
from speechflow_torch.scripts.common import (
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
from speechflow_torch.training.gan_trainer import GANTrainer
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.utils.device import resolve_device
from speechflow_torch.utils.init import filter_kwargs

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["MODEL_CONFIG", "DATA_CONFIG", "configs", "train", "main"]

MODEL_CONFIG = "configs/vocoder_bigvgan.yml"
DATA_CONFIG = "configs/vocoder_data_24khz.yml"


def configs(value_select: tp.Union[str, tp.Sequence[str], None] = "default",
            model_config: tp.Union[str, Path] = MODEL_CONFIG,
            data_config: tp.Union[str, Path] = DATA_CONFIG,
            data_root: tp.Union[str, Path, None] = None) -> tp.Tuple[dict, dict]:
    """(model config, data config) read from the YAML files (the flagship
    recipe by default) with ``value_select``: fresh dicts."""
    return read_configs(model_config, data_config, value_select, data_root)


def train(model_cfg: tp.Mapping, data_cfg: tp.Mapping, saver: tp.Optional[ExperimentSaver],
          device: tp.Union[str, torch.device, None] = None,
          callbacks: tp.Sequence[tp.Callable] = (),
          tb_dir: tp.Optional[tp.Union[str, Path]] = None) -> str:
    """Build and fit the GAN; returns the experiment directory. Scalars go to
    TensorBoard under ``tb_dir`` when one is given (which then needs the
    ``tensorboard`` package). As one rank of a data-parallel run: as
    ``train_tts.train`` (each micro-batch is the rank's slice of the global one)."""
    dev = resolve_device(device)
    init_distributed(device=dev)
    params = VocosParams.create(model_cfg["model"])
    loss_cfg = dict(model_cfg.get("loss") or {})
    gen_crit = vocoder_gen_criterion(sample_rate=params.sample_rate, n_mels=params.n_mels,
                                     device=dev,
                                     **filter_kwargs(vocoder_gen_criterion, loss_cfg))
    cfg = trainer_config(model_cfg)
    data_parallel_ranks(cfg)
    pipeline, loaders = build_data(data_cfg, model_cfg)
    try:
        if params.feature_extractor == "tts":
            # E2E GAN-TTS: the acoustic model inside the generator, sized from the data
            params.tts_params = model_config_from_info(
                {"model": dict(params.tts_params)}, pipeline)
            batch_processor = E2EBatchProcessor(device=dev)
        else:
            batch_processor = VocoderBatchProcessor(device=dev)
        torch.manual_seed(cfg.seed)
        with dev:  # initialised on the device they train on (seconds on a host's CPU)
            generator = Vocos(params).to(dev)
            discriminator = VocoderDiscriminator(**filter_kwargs(
                VocoderDiscriminator.__init__, model_cfg.get("discriminator") or {})).to(dev)
        if saver is not None:
            saver.to_save["pipeline_info"] = pipeline.get_info()
            saver.to_save["model_params"] = dataclasses.asdict(params)
        gan_cfg = model_cfg.get("gan") or {}
        gan = GANTrainer(
            generator, discriminator, gen_crit, vocoder_disc_criterion(),
            batch_processor,
            gen_optimizer=optimizer_config(model_cfg),
            disc_optimizer=optimizer_config(
                model_cfg, "disc_optimizer" if model_cfg.get("disc_optimizer")
                else "optimizer"),
            config=cfg, saver=saver,
            disc_every=int(gan_cfg.get("disc_every", 1)),
            disc_start_iter=int(gan_cfg.get("disc_start_iter", 0)),
            tb_dir=tb_dir,
            evaluate_pesq=bool(gan_cfg.get("evaluate_pesq", False)))
        resume_from = (model_cfg.get("resume") or {}).get("from")
        if resume_from:
            ckpt = ExperimentSaver.get_last_checkpoint(resume_from)
            if ckpt is None:
                raise FileNotFoundError(f"no checkpoint under {resume_from}")
            gan.load_checkpoint(ckpt)
            LOGGER.info("resumed GAN from %s at step %d", ckpt, gan.global_step)
        disc_from = (model_cfg.get("warmstart") or {}).get("disc_from")
        if disc_from:
            gan.warmstart_discriminator(disc_from)
        last = gan.fit(loaders["train"], loaders.get("test"), callbacks=callbacks)
        LOGGER.info("vocoder training done: %s", last)
        return rank_experiment(saver)
    finally:
        close_data(loaders)


def main(argv=None) -> str:
    args = train_arguments("GAN training of a vocoder", MODEL_CONFIG,
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
