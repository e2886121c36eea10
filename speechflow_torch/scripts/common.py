"""What the training entry points share (counterpart of the parts of
``speechflow_tpu/scripts/common.py`` the training scripts use): the command
line (``train_arguments``), the configs read from YAML files with one
``value_select`` applied (``read_configs``, through ``io.config``, which needs
no PyYAML), the experiment directory with the configs' YAML text, the data
pipeline and its loaders, the optimizer and trainer configs read from a model
config, the model params sized from the pipeline (``model_config_from_info``),
and the resume / finetune / warm-start wiring (``apply_resume_warmstart``).

Configs are plain nested dicts: the sections of the YAML files.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import logging
import os
import typing as tp
from pathlib import Path

from speechflow_torch.convert import load_nnx_state, nnx_from_module
from speechflow_torch.data.core.components import AudioLoader, DataPipeline
from speechflow_torch.io.config import Config, yaml_dump
from speechflow_torch.parallel.distributed import process_count, process_index
from speechflow_torch.training.optimizer import OptimizerConfig
from speechflow_torch.training.saver import ExperimentSaver, is_checkpoint
from speechflow_torch.training.trainer import TrainerConfig

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["REPO", "train_arguments", "read_configs", "configs_of_args", "experiment_saver",
           "source_checkpoint", "resume_singletons", "build_data", "close_data",
           "model_config_from_info", "trainer_config", "optimizer_config",
           "apply_resume_warmstart", "rank_experiment", "data_parallel_ranks",
           "experiment_log"]

REPO = Path(__file__).resolve().parents[2]


def _config_path(path: tp.Union[str, Path]) -> Path:
    """``path`` as given, or, a relative path that does not exist from the
    working directory, under this checkout (``configs/...``)."""
    p = Path(path)
    return p if p.exists() or p.is_absolute() else REPO / p


def read_configs(model_config: tp.Union[str, Path], data_config: tp.Union[str, Path],
                 value_select: tp.Optional[tp.Sequence[str]] = None,
                 data_root: tp.Optional[tp.Union[str, Path]] = None
                 ) -> tp.Tuple[dict, dict]:
    """(model config, data config) of two YAML files with ``value_select``
    applied (``["debug"]``, or a bare selector), as fresh plain dicts;
    ``data_root`` replaces the data config's ``dirs.data_root``."""
    if isinstance(value_select, str):
        value_select = [value_select]
    model_cfg = Config.create_from_file(_config_path(model_config), value_select).to_dict()
    data_cfg = Config.create_from_file(_config_path(data_config), value_select).to_dict()
    if data_root is not None:
        data_cfg.setdefault("dirs", {})["data_root"] = str(data_root)
    return model_cfg, data_cfg


def train_arguments(description: str, model_config: str, data_config: str
                    ) -> argparse.ArgumentParser:
    """The training scripts' flags, as JAX's ``train_arguments`` has them, with
    the repository's recipe as each config's default and ``--device`` (the GPU
    unless ``cpu``), ``--experiment_dir``, ``--tb`` and ``--use_mesh``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("-c", "--model_config", default=model_config,
                    help=f"a model config YAML file (default {model_config})")
    ap.add_argument("-cd", "--data_config", default=data_config,
                    help=f"a data config YAML file (default {data_config})")
    ap.add_argument("-vs", "--value_select", nargs="*", default=None,
                    help="selectors of the configs' {default: ..., <selector>: ...} values")
    ap.add_argument("-r", "--resume_from", default=None)
    ap.add_argument("-w", "--warmstart", default=None, help="warmstart.ckpt")
    ap.add_argument("--data_root", default=None, help="replaces dirs.data_root")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--experiment_dir", default=None)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU")
    ap.add_argument("--tb", action="store_true", help="TensorBoard scalars in <experiment>/tb")
    ap.add_argument("--use_mesh", action="store_true",
                    help="trainer.use_mesh: data parallel over the ranks of the environment "
                         "contract (SPEECHFLOW_COORDINATOR, _NUM_PROCESSES, _PROCESS_ID)")
    return ap


def configs_of_args(args: argparse.Namespace) -> tp.Tuple[dict, dict]:
    """The parsed flags' configs with their overrides, as JAX's
    ``config_prepare`` applies them: ``--data_root``, ``--max_steps``,
    ``-r`` (``resume.from``) and ``-w`` (``warmstart.ckpt``); and ``--use_mesh``."""
    model_cfg, data_cfg = read_configs(args.model_config, args.data_config,
                                       args.value_select, args.data_root)
    if args.max_steps:
        model_cfg.setdefault("trainer", {})["max_steps"] = args.max_steps
    if getattr(args, "use_mesh", False):
        model_cfg.setdefault("trainer", {})["use_mesh"] = True
    if args.resume_from:
        model_cfg.setdefault("resume", {})["from"] = args.resume_from
    if args.warmstart:
        model_cfg.setdefault("warmstart", {})["ckpt"] = args.warmstart
    return model_cfg, data_cfg


def experiment_saver(model_cfg: tp.Mapping, data_cfg: tp.Mapping,
                     base_dir: tp.Optional[tp.Union[str, Path]] = None) -> ExperimentSaver:
    """A new experiment directory under ``base_dir`` (else the config's
    ``experiment.base_dir``), named after ``experiment.name``, with both
    configs' YAML text (overrides applied) written beside the checkpoints and
    into the payload, as JAX's ``save_configs`` writes them."""
    exp = model_cfg.get("experiment") or {}
    saver = ExperimentSaver(base_dir or exp.get("base_dir", "experiments"),
                            expr_suffix=exp.get("name", "run"))
    saver.save_configs(data_cfg_text=yaml_dump(data_cfg), model_cfg_text=yaml_dump(model_cfg))
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
            if not is_checkpoint(src):
                raise FileNotFoundError(f"{kind}.ckpt {src} is not a checkpoint directory")
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
    ``data_loaders.n_workers`` and ``prefetch_factor``.

    Under a process group of several ranks (``parallel.init_distributed``)
    ``batch.size`` is the global batch: rank 0 builds the pipeline and hosts the
    data server and its workers for every rank, each rank's loaders draw
    ``size // world`` samples, its slice of each global batch, and the other
    ranks rebuild the pipeline's metadata from the server's info. Then the
    loaders are a ``server.LoaderBundle``: ``close_data`` stops them."""
    dl = model_cfg.get("data_loaders") or {}
    batch_size = int((model_cfg.get("batch") or {}).get("size", 8))
    world = process_count()
    if world > 1:
        from speechflow_torch.server import init_data_loader_distributed

        pipeline = None
        if process_index() == 0:
            pipeline = DataPipeline.from_config(data_cfg,
                                                seed_singletons=resume_singletons(model_cfg))
        bundle = init_data_loader_distributed(
            pipeline, batch_size=max(batch_size // world, 1),
            n_workers=int(dl.get("n_workers", 2)),
            prefetch_factor=int(dl.get("prefetch_factor", 8)),
            min_prefetch={"train": 2})  # the others start at their first batch
        if pipeline is None:
            pipeline = DataPipeline.from_info(next(iter(bundle.values())).info)
        return pipeline, bundle
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


def close_data(loaders: tp.Mapping) -> None:
    """Stop ``build_data``'s loaders (and the data server behind them)."""
    if hasattr(loaders, "shutdown"):
        loaders.shutdown()
    else:
        for ld in loaders.values():
            ld.close()


@contextlib.contextmanager
def experiment_log(saver: tp.Optional[ExperimentSaver]):
    """Rank 0's ``LoggingServer`` on the experiment's ``experiment.log`` (rank 0 alone
    has the saver), as JAX's scripts wrap their training; the other ranks send it
    their records (and so do the data workers every rank spawns)."""
    from speechflow_torch.logging import LoggingServer, attach_socket_handler
    from speechflow_torch.logging.server import LOG_ADDR_ENV
    from speechflow_torch.parallel.distributed import broadcast_bytes

    if saver is not None:
        with LoggingServer.ctx(saver.expr_path) as server:
            if process_count() > 1:
                broadcast_bytes(server.address.encode())
            yield
        return
    address = broadcast_bytes(None).decode()
    os.environ[LOG_ADDR_ENV] = address
    attach_socket_handler(address)
    yield


def data_parallel_ranks(cfg) -> int:
    """The number of ranks a run trains over; several need ``trainer.use_mesh``."""
    world = process_count()
    if world > 1 and not cfg.use_mesh:
        raise ValueError(f"{world} ranks are running: set trainer.use_mesh to train "
                         "data-parallel")
    return world


def rank_experiment(saver: tp.Optional[ExperimentSaver]) -> str:
    """Rank 0's experiment directory, on every rank (rank 0 alone has a saver)."""
    from speechflow_torch.parallel.distributed import broadcast_bytes

    path = str(saver.expr_path) if saver is not None else None
    if process_count() == 1:
        return path or ""
    return broadcast_bytes(path.encode() if process_index() == 0 else None).decode()


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
    """The model config's start (``source_checkpoint``), from a checkpoint of
    either package:

    - ``resume.from`` (an experiment or checkpoint directory): the last
      checkpoint's weights, optimizer state and step (a JAX checkpoint's optax
      state mapped by ``training.optax_state``; a checkpoint without optimizer
      state is refused);
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
