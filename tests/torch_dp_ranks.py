"""The rank processes of ``tests/test_torch_distributed.py`` (and of its GPU
case): torch and the port only, so that a rank (a fork of the port's
forkserver, ``concurrency.context.worker_context``) starts quickly.

``run_rank`` joins the process group through the environment contract
(``SPEECHFLOW_COORDINATOR``, ``SPEECHFLOW_NUM_PROCESSES``,
``SPEECHFLOW_PROCESS_ID``), round-trips ``broadcast_bytes``, runs each job of a
pickled dict (``tts_steps`` or ``gan_steps``) on its slice of the job's global
batches with ``use_mesh``, and pickles what it saw. The same job functions run
in one process (no group) for the reference.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import typing as tp

import numpy as np
import torch


def tts_batch(b: int, n: int, lens, n_mels: int, seed: int = 0, n_symbols: int = 20,
              n_speakers: int = 3, n_langs: int = 2, feat_dims=(56, 32, 32)) -> dict:
    """A collated acoustic-model batch of ``b`` utterances (the fields of
    ``tests/torch_parity.tts_arrays``, 2..5 frames a token), zero past each one's
    length and padded to the longest, as a collate pads it."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int32)
    valid = np.arange(n)[None] < lens[:, None]
    feats = [rng.normal(size=(b, n, d)).astype(np.float32) * valid[..., None]
             for d in feat_dims]
    durations = np.where(valid, rng.integers(2, 6, (b, n)), 0).astype(np.float32)
    mel_lens = durations.sum(1).astype(np.int32)
    t = int(mel_lens.max())
    frames = np.arange(t)[None] < mel_lens[:, None]
    return dict(
        transcription=np.where(valid, rng.integers(1, n_symbols, (b, n)), 0).astype(np.int32),
        transcription_lengths=lens,
        speaker_id=rng.integers(0, n_speakers, (b,)).astype(np.int32),
        lang_id=rng.integers(0, n_langs, (b,)).astype(np.int32),
        durations=durations, ling_feat=feats[0], lm_feat=feats[1], xpbert_feat=feats[2],
        mel=(rng.normal(size=(b, t, n_mels)) * frames[..., None]).astype(np.float32),
        mel_lengths=mel_lens,
        aggregate_pitch=(rng.uniform(80, 300, (b, n)) * valid).astype(np.float32),
        aggregate_energy=(rng.uniform(0, 20, (b, n)) * valid).astype(np.float32),
        gate=(np.arange(t)[None] >= mel_lens[:, None] - 1).astype(np.float32))


def _no_dropout(module: torch.nn.Module) -> None:
    for m in module.modules():
        if isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0


def _weights(module: torch.nn.Module) -> tp.Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


def _load(module: torch.nn.Module, weights: tp.Mapping[str, np.ndarray], device) -> None:
    module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in weights.items()})
    module.to(device)


def tts_steps(job: dict, rank: int, device: str = "cpu") -> dict:
    """``Trainer`` steps of the acoustic model on ``job["batches"][rank]`` with
    the CFM draws ``job["draws"][rank]`` (u, z, content and condition masks)."""
    from speechflow_torch.data.collate import CollatedTTS
    from speechflow_torch.models.tts import TTSCriterion
    from speechflow_torch.models.tts.batch_processor import TTSBatchProcessor
    from speechflow_torch.models.tts.decoders import CFMDraws
    from speechflow_torch.models.tts.model import ParallelTTSModel, ParallelTTSParams
    from speechflow_torch.training.optimizer import OptimizerConfig
    from speechflow_torch.training.trainer import Trainer, TrainerConfig

    model = ParallelTTSModel(ParallelTTSParams.create(job["params"]))
    _load(model, job["weights"], device)
    _no_dropout(model)
    draws = iter([CFMDraws(*(torch.from_numpy(a).to(device) for a in d))
                  for d in job["draws"][rank]])
    model.decoder.draw = lambda *a, **k: next(draws)
    trainer = Trainer(model, TTSCriterion(**job["loss"]), TTSBatchProcessor(),
                      OptimizerConfig.from_config(job["opt"]),
                      TrainerConfig(max_steps=100, use_mesh=True))
    losses = [{k: float(v) for k, v in trainer.training_step(CollatedTTS(**b)).items()}
              for b in job["batches"][rank]]
    return {"losses": losses, "weights": _weights(model)}


@contextlib.contextmanager
def kinks(pins: dict):
    """The discriminators' leaky ReLUs and the hinge losses with each element's
    side of 0 recorded in call order (``pins["masks"]`` None) or replayed from
    ``pins["masks"]``; ``pins["flips"]`` counts the elements that fell on the
    other side here (as ``chip_smoke.py``'s ``pinned_kinks``)."""
    from speechflow_torch.models.vocoder import criterion
    from speechflow_torch.models.vocoder import discriminators as D

    record = pins.get("masks") is None
    if record:
        pins["masks"] = []
    pins["flips"], calls = 0, iter(range(len(pins["masks"])))

    def side(on):
        if record:
            pins["masks"].append(on)
            return on
        mask = pins["masks"][next(calls)]
        pins["flips"] += int((mask != on).sum())
        return mask

    def leaky_relu(x, negative_slope=0.1):
        return torch.where(side(x >= 0), x, x * negative_slope)

    def hinge(x):
        return x * side(x > 0)

    real = D.leaky_relu, criterion._relu
    D.leaky_relu, criterion._relu = leaky_relu, hinge
    try:
        yield
    finally:
        D.leaky_relu, criterion._relu = real


def gan_steps(job: dict, rank: int, device: str = "cpu") -> dict:
    """``GANTrainer`` micro-batches of the vocoder on ``job["batches"][rank]`` in
    ``job["dtype"]`` (float32 by default), the kinks recorded, or replayed from
    ``job["masks"]``."""
    from speechflow_torch.models.vocoder import Vocos, VocosParams
    from speechflow_torch.models.vocoder.batch_processor import VocoderBatchProcessor
    from speechflow_torch.models.vocoder.criterion import (
        vocoder_disc_criterion,
        vocoder_gen_criterion,
    )
    from speechflow_torch.models.vocoder.discriminators import VocoderDiscriminator
    from speechflow_torch.training.gan_trainer import GANTrainer
    from speechflow_torch.training.optimizer import OptimizerConfig
    from speechflow_torch.training.trainer import TrainerConfig

    cfg = job["model_cfg"]
    dtype = getattr(torch, job.get("dtype", "float32"))
    gen = Vocos(VocosParams.create(cfg["model"]))
    disc = VocoderDiscriminator(**cfg["discriminator"])
    _load(gen, job["gen_weights"], device)
    _load(disc, job["disc_weights"], device)
    gen.to(dtype)
    disc.to(dtype)
    opt = OptimizerConfig.from_config(job["opt"])
    gan = GANTrainer(gen, disc,
                     vocoder_gen_criterion(n_mels=cfg["model"]["n_mels"], device=device,
                                           **job["loss"]),
                     vocoder_disc_criterion(), VocoderBatchProcessor(device=device),
                     gen_optimizer=opt, disc_optimizer=opt,
                     config=TrainerConfig(max_steps=100, use_mesh=True))
    masks = job.get("masks")
    pins = {"masks": None if masks is None else [torch.from_numpy(m).to(device)
                                                 for m in masks]}
    with kinks(pins):
        losses = [{k: float(v) for k, v in gan.training_step(
            {n: np.asarray(w, dtype=job.get("dtype", "float32")) for n, w in b.items()}).items()}
            for b in job["batches"][rank]]
    return {"losses": losses, "gen": _weights(gen), "disc": _weights(disc),
            "masks": [m.cpu().numpy() for m in pins["masks"]], "flips": pins["flips"]}


def synthetic_pipeline(n: int):
    """``n`` bare samples labelled by index, each with a 64 x 64 payload, behind
    ``tests/tools/torch_mutating_handler.PayloadCollate`` and a ``SimpleSampler``."""
    from speechflow_torch.data.core.components import DataPipeline
    from speechflow_torch.data.core.datasample import DataSample
    from speechflow_torch.data.samplers import SimpleSampler

    cfg = {"dataset": {"subsets": ["train"]}, "collate": {"type": "PayloadCollate"},
           "preproc": {"imports": ["tests.tools.torch_mutating_handler"], "pipe": []}}
    samples = [DataSample(label=str(i), index=i,
                          additional={"payload": np.full((64, 64), float(i), np.float32)})
               for i in range(n)]
    dp = DataPipeline.from_info({"config": cfg, "subsets": ["train"], "alphabet": None,
                                 "singletons": {}, "dataset_sizes": {"train": n}})
    dp.datasets = {"train": samples}
    dp.samplers = {"train": SimpleSampler().set_dataset(samples)}
    return dp


def dataplane(job: dict, rank: int, device: str = "cpu") -> dict:
    """``init_data_loader_distributed``: rank 0 hosts the server over ``job["n"]``
    samples (the others pass no pipeline); every rank's keys of ``job["batches"]``
    batches of its share ``job["batch"]``."""
    from speechflow_torch.server import init_data_loader_distributed

    pipeline = synthetic_pipeline(job["n"]) if rank == 0 else None
    bundle = init_data_loader_distributed(pipeline, batch_size=job["batch"], n_workers=1,
                                          prefetch_factor=2)
    try:
        items = [bundle["train"].next_item(timeout=60) for _ in range(job["batches"])]
        keys = [item.keys for item in items]
        payloads = [np.asarray(item.collated["payload"]) for item in items]
        hosts = bool(bundle.servers)
    finally:
        bundle.shutdown()
    return {"keys": keys, "payloads": payloads, "hosts_server": hosts}


RUNNERS = {"tts": tts_steps, "gan": gan_steps, "dataplane": dataplane}


def run_rank(rank: int, world: int, port: int, job_file: str, out_file: str,
             device: str = "cpu") -> None:
    torch.set_num_threads(1)
    os.environ.update(SPEECHFLOW_COORDINATOR=f"127.0.0.1:{port}",
                      SPEECHFLOW_NUM_PROCESSES=str(world), SPEECHFLOW_PROCESS_ID=str(rank))
    from speechflow_torch.parallel import distributed as D

    out: tp.Dict[str, tp.Any] = {"init": D.init_distributed(device=device, timeout_s=60)}
    try:
        out["backend"] = D.backend()
        out["broadcast"] = D.broadcast_bytes(b"rank 0's bytes" if rank == 0 else None)
        with open(job_file, "rb") as f:
            jobs = pickle.load(f)
        for name, job in jobs.items():
            out[name] = RUNNERS[job["kind"]](job, rank, device)
    finally:
        D.shutdown_distributed()
    with open(out_file, "wb") as f:
        pickle.dump(out, f)


def start_world(world: int, jobs: dict, tmp, device: str = "cpu") -> dict:
    """``world`` ranks started over ``jobs``; ``join_world`` waits for them, so the
    caller may compute its reference meanwhile."""
    from speechflow_torch.concurrency.context import worker_context
    from speechflow_torch.server.transport import find_free_port

    ctx = worker_context()
    job_file = os.path.join(str(tmp), "jobs.pkl")
    with open(job_file, "wb") as f:
        pickle.dump(jobs, f)
    outs = [os.path.join(str(tmp), f"rank{r}.pkl") for r in range(world)]
    port = find_free_port()
    procs = [ctx.Process(target=run_rank, args=(r, world, port, job_file, outs[r], device))
             for r in range(world)]
    handle = {"procs": [], "outs": outs}
    try:
        for proc in procs:
            proc.start()
            handle["procs"].append(proc)
    except BaseException:
        join_world(handle, 0.0)
        raise
    return handle


def join_world(handle: dict, timeout_s: float = 60.0) -> tp.List[dict]:
    """Every rank of ``start_world`` joined within ``timeout_s`` together, and
    killed if it is still alive; a rank that failed or outlived it raises."""
    import time

    procs = handle["procs"]
    deadline = time.time() + timeout_s
    try:
        for proc in procs:
            proc.join(max(deadline - time.time(), 0.0))
        alive = [r for r, proc in enumerate(procs) if proc.is_alive()]
        assert not alive, f"ranks {alive} still running after {timeout_s} s"
        codes = [proc.exitcode for proc in procs]
        assert codes == [0] * len(procs), f"rank exit codes {codes}"
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(5)
    results = []
    for o in handle["outs"]:
        with open(o, "rb") as f:
            results.append(pickle.load(f))
    return results


def run_world(world: int, jobs: dict, tmp, device: str = "cpu",
              timeout_s: float = 60.0) -> tp.List[dict]:
    """``world`` ranks over ``jobs``, joined within ``timeout_s`` (``join_world``)."""
    return join_world(start_world(world, jobs, tmp, device), timeout_s)
