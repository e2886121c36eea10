"""Vocoder (GAN) training (counterpart of ``speechflow_tpu/scripts/train_vocoder.py``).

Builds the data (``configs/vocoder_data_24khz.yml``), the Vocos generator,
the ``VocoderDiscriminator``, both criteria and ``GANTrainer``, then
``fit``s. The configs are the presets below, transcribed from
``configs/vocoder_bigvgan.yml`` and ``configs/vocoder_data_24khz.yml`` per
``value_select`` (a CPU test holds them equal to the YAML files); the model
section is ``serving.VOCODER_BIGVGAN_PRESETS``.

    python -m speechflow_torch.scripts.train_vocoder -vs debug --device cpu
    python -m speechflow_torch.scripts.train_vocoder --max_steps 16   # on the GPU

It runs on the GPU unless ``device="cpu"``. Weights start from
``torch.manual_seed(trainer.seed)``. ``resume.from`` and
``warmstart.disc_from`` read the port's own checkpoints. Not ported, and
raising ``NotImplementedError`` with the module they need: the ``tts``
feature extractor (E2E GAN-TTS), ``loss.cpc_ckpt`` and ``loss.bio_ckpt``
(CPC, ECAPA) and a MOS model for validation (``gan.mos_ckpt``).
"""

from __future__ import annotations

import argparse
import copy
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
from speechflow_torch.scripts.common import (
    build_data,
    experiment_saver,
    optimizer_config,
    trainer_config,
)
from speechflow_torch.serving import VOCODER_BIGVGAN_PRESETS
from speechflow_torch.training.gan_trainer import GANTrainer
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.utils.device import resolve_device
from speechflow_torch.utils.init import filter_kwargs

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["VOCODER_BIGVGAN_TRAIN_PRESETS", "VOCODER_DATA_PRESETS", "configs", "train",
           "main"]

REPO = Path(__file__).resolve().parents[2]

# configs/vocoder_bigvgan.yml, the sections other than "model", per value_select
VOCODER_BIGVGAN_TRAIN_PRESETS: tp.Dict[str, dict] = {
    "default": {
        "experiment": {"name": "vocos_bigvgan", "base_dir": "experiments"},
        "batch": {"size": 32},
        "trainer": {"max_steps": 2000000, "log_every": 100, "ckpt_every": 20000,
                    "val_every": 5000, "val_batches": 8, "mixed_precision": True},
        "data_loaders": {"n_workers": 4, "prefetch_factor": 16},
        "optimizer": {"method": "adamw", "lr": 0.0002, "lr_schedule": "WarmupCosine",
                      "lr_schedule_kwargs": {"warmup_steps": 2000, "decay_steps": 2000000},
                      "grad_clip": 1.0, "grad_accum": 8},
        "gan": {"disc_every": 1, "disc_start_iter": 0, "evaluate_pesq": True},
        "loss": {"mel_weight": 45.0, "fm_weight": 2.0, "stft_weight": 1.0,
                 "adv_weight": 1.0, "adv_start_iter": 0},
        "discriminator": {"periods": [2, 3, 5, 7, 11],
                          "resolutions": [[1024, 256], [2048, 512], [512, 128]],
                          "channels": 32, "use_cqt": True, "sample_rate": 24000},
    },
    "debug": {
        "experiment": {"name": "vocos_bigvgan", "base_dir": "experiments"},
        "batch": {"size": 2},
        "trainer": {"max_steps": 6, "log_every": 2, "ckpt_every": 6, "val_every": 3,
                    "val_batches": 1, "mixed_precision": False},
        "data_loaders": {"n_workers": 1, "prefetch_factor": 2},
        "optimizer": {"method": "adamw", "lr": 0.001, "lr_schedule": "WarmupCosine",
                      "lr_schedule_kwargs": {"warmup_steps": 2, "decay_steps": 100},
                      "grad_clip": 1.0, "grad_accum": 1},
        "gan": {"disc_every": 1, "disc_start_iter": 2, "evaluate_pesq": False},
        "loss": {"mel_weight": 45.0, "fm_weight": 2.0, "stft_weight": 1.0,
                 "adv_weight": 1.0, "adv_start_iter": 1000000},
        "discriminator": {"periods": [2, 3, 5, 7, 11],
                          "resolutions": [[1024, 256], [2048, 512], [512, 128]],
                          "channels": 8, "use_cqt": True, "sample_rate": 24000},
    },
}


def _data_preset(split_ratio: float, max_num_samples: tp.Optional[int],
                 chunk_duration: float) -> dict:
    return {
        "dirs": {"data_root": str(REPO / "tests" / "data" / "SEGS")},
        "file_search": {"ext": ".wav"},
        "dataset": {"subsets": ["train", "test"], "split_ratio": split_ratio,
                    "max_num_samples": max_num_samples},
        "parser": {"type": "AudioDSParser"},
        "preproc": {"pipe": ["load_audio", "volume_normalize", "random_chunk",
                             "multiple_audio"],
                    "pipe_cfg": {"load_audio": {"sample_rate": 24000},
                                 "random_chunk": {"chunk_duration": chunk_duration},
                                 "multiple_audio": {"hop": 256}}},
        "singleton_handlers": ["SpeakerIDSetter", "DatasetStatistics"],
        "collate": {"type": "AudioCollate", "sample_multiple": 256},
        "processor": {},
        "sampler": {"train": {"type": "RandomSampler"}, "test": {"type": "SimpleSampler"}},
    }


# configs/vocoder_data_24khz.yml, per value_select; data_root is this checkout's
# tests/data/SEGS, the corpus the YAML names
VOCODER_DATA_PRESETS: tp.Dict[str, dict] = {
    "default": _data_preset(0.9, None, 1.0),
    "debug": _data_preset(0.5, 6, 0.35),
}


def configs(value_select: str = "default") -> tp.Tuple[dict, dict]:
    """(model config, data config) of the flagship vocoder recipe: fresh copies."""
    model_cfg = copy.deepcopy(VOCODER_BIGVGAN_TRAIN_PRESETS[value_select])
    model_cfg["model"] = copy.deepcopy(VOCODER_BIGVGAN_PRESETS[value_select])
    return model_cfg, copy.deepcopy(VOCODER_DATA_PRESETS[value_select])


def train(model_cfg: tp.Mapping, data_cfg: tp.Mapping, saver: ExperimentSaver,
          device: tp.Union[str, torch.device, None] = None,
          callbacks: tp.Sequence[tp.Callable] = (),
          tb_dir: tp.Optional[tp.Union[str, Path]] = None) -> str:
    """Build and fit the GAN; returns the experiment directory. Scalars go to
    TensorBoard under ``tb_dir`` when one is given (which then needs the
    ``tensorboard`` package)."""
    dev = resolve_device(device)
    params = VocosParams.create(model_cfg["model"])
    if params.feature_extractor == "tts":
        raise NotImplementedError("feature_extractor 'tts' (E2E GAN-TTS): "
                                  "models/vocoder/tts_features.py is not ported yet")
    if (model_cfg.get("gan") or {}).get("mos_ckpt"):
        raise NotImplementedError("gan.mos_ckpt: models/vocoder/mos_proxy.py is not "
                                  "ported yet")
    loss_cfg = dict(model_cfg.get("loss") or {})
    gen_crit = vocoder_gen_criterion(sample_rate=params.sample_rate, n_mels=params.n_mels,
                                     **filter_kwargs(vocoder_gen_criterion, loss_cfg))
    cfg = trainer_config(model_cfg)
    torch.manual_seed(cfg.seed)
    generator = Vocos(params).to(dev)
    discriminator = VocoderDiscriminator(**filter_kwargs(
        VocoderDiscriminator.__init__, model_cfg.get("discriminator") or {})).to(dev)
    pipeline, loaders = build_data(data_cfg, model_cfg)
    try:
        saver.to_save["pipeline_info"] = pipeline.get_info()
        saver.to_save["model_params"] = dataclasses.asdict(params)
        gan_cfg = model_cfg.get("gan") or {}
        gan = GANTrainer(
            generator, discriminator, gen_crit, vocoder_disc_criterion(),
            VocoderBatchProcessor(device=dev),
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
        return str(saver.expr_path)
    finally:
        for ld in loaders.values():
            ld.close()


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="GAN training of the flagship vocoder")
    ap.add_argument("-vs", "--value_select", default="default", choices=["default", "debug"])
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--experiment_dir", default=None)
    ap.add_argument("-r", "--resume_from", default=None)
    ap.add_argument("--device", default=None, help="cpu to run the plain versions there")
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
