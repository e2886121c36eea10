"""Driver of the vocoder's GAN training: ``GANTrainer.training_step`` of the
port's trainer over the generator, the discriminator, the criteria and the
optimizers the configuration describes, in a closed loop of micro-batches.

Set-up builds one trainer from the seed's weights and drives it through its
first ``check_steps`` optimizer steps (``grad_accum`` micro-batches each, rows
that all differ), keeping the parameters before them, the gradient each
optimizer took at its first step (AdamW's first moment after one step over
1 - beta1) and the parameters after them; these micro-batches are the warm-up.
The window then goes on with the same trainer, one synchronised micro-batch
after another, until ``seconds`` have passed. A traced run then profiles one
whole accumulation cycle. Last, with the program freed, the reference replays
the first steps on the same rows.

The traffic module the workload's ``traffic.generator`` names gives
``make_batches(params, seed, device, root)``: an object with ``batch_at(i)``
(micro-batch i on the device), ``seconds`` (audio a micro-batch) and ``width``
(samples a row).
"""

from __future__ import annotations

import gc
import time
import typing as tp

import torch

from port_bench import compare, core
from port_bench import trace as T
from port_bench.reference import nn as R
from port_bench.reference.gan import Discriminator, GANStep
from port_bench.reference.vocoder import Vocoder


def make_weights(cfg: dict, seed: int, device) -> tp.Tuple[dict, dict]:
    with torch.device("meta"):
        g_spec, d_spec = Vocoder(cfg["generator"]), Discriminator(cfg["discriminator"])
    vectors = cfg["weights"]["vectors"]
    return (core.make_weights(torch, g_spec, seed, device, vectors),
            core.make_weights(torch, d_spec, seed + 1, device, vectors))


def build_program(cfg: dict, w_g: dict, w_d: dict, device):
    """The port's trainer as ``scripts/train_vocoder.py`` builds it, with the
    benchmark's weights."""
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

    g = cfg["generator"]
    core.log("program imported")
    with torch.device(device):
        gen = Vocos(VocosParams.create(dict(g)))
        disc = VocoderDiscriminator(**cfg["discriminator"])
    core.log("program's modules made")
    gen.load_state_dict(w_g)
    disc.load_state_dict(w_d)
    opt = OptimizerConfig.from_config(cfg["optimizer"])
    return GANTrainer(
        gen, disc,
        vocoder_gen_criterion(sample_rate=g["sample_rate"], n_mels=g["n_mels"], device=device,
                              **cfg["loss"]),
        vocoder_disc_criterion(), VocoderBatchProcessor(device=device),
        gen_optimizer=opt, disc_optimizer=OptimizerConfig.from_config(cfg["optimizer"]),
        config=TrainerConfig(mixed_precision=bool(cfg["trainer"]["mixed_precision"])),
        disc_every=cfg["gan"]["disc_every"], disc_start_iter=cfg["gan"]["disc_start_iter"])


def _params(gan) -> tp.Dict[str, torch.Tensor]:
    out = {f"generator.{k}": p for k, p in gan.generator.named_parameters()}
    out.update({f"discriminator.{k}": p for k, p in gan.discriminator.named_parameters()})
    return out


def _first_grads(gan, beta1: float) -> tp.Dict[str, torch.Tensor]:
    """The gradient each optimizer took at its first step, from its state."""
    out = {}
    for prefix, opt in (("generator", gan.gen_opt), ("discriminator", gan.disc_opt)):
        for name, p in zip(opt.names, opt.params):
            out[f"{prefix}.{name}"] = opt.base.state[p]["exp_avg"].detach().clone() / (1 - beta1)
    return out


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    cfg, params = cell.config, cell.workload["traffic"]
    accum = int(cfg["optimizer"]["grad_accum"])
    beta1 = float(cfg["optimizer"]["betas"][0])
    chunks = core.traffic(params).make_batches(dict(params, batch=cfg["batch"], **cfg["data"]),
                                               seed, device, core.ROOT)
    w_g, w_d = make_weights(cfg, seed, device)
    core.log(f"corpus on the device, {len(chunks)} micro-batches planned, weights drawn")
    gan = build_program(cfg, w_g, w_d, device)
    del w_g, w_d
    core.log("program built")
    before = {k: p.detach().clone() for k, p in _params(gan).items()}
    n_check = params["check_steps"] * accum
    losses, first = [], None
    for i in range(n_check):
        m = gan.training_step({"waveform": chunks.batch_at(i)})
        losses.append((m["gen/total"], m["disc/total"]))
        if i == accum - 1:
            first = _first_grads(gan, beta1)
    delta = {k: p.detach() - before[k] for k, p in _params(gan).items()}
    del before
    prog = {"losses": [(float(g), float(d)) for g, d in losses], "first_grad": first,
            "delta": delta}
    torch.cuda.synchronize()
    core.log(f"first {params['check_steps']} optimizer steps ({n_check} micro-batches) done")

    torch.cuda.reset_peak_memory_stats()
    setup_s = core.process_age_s()
    t0 = time.perf_counter()
    i = n_check
    while True:
        gan.training_step({"waveform": chunks.batch_at(i)})
        torch.cuda.synchronize()
        te = time.perf_counter()
        i += 1
        if te - t0 >= seconds:
            break
    window_s = te - t0
    n_mb = i - n_check
    peak = torch.cuda.max_memory_allocated()
    core.log(f"window: {n_mb} micro-batches in {window_s:.3f} s")
    res = {"attempted": n_mb, "failed": 0, "setup_s": setup_s,
           "e2e": {"train_audio_s_per_s": n_mb * chunks.seconds / window_s},
           "layer": {"config": cfg, "peak_bytes": peak, "rows": cfg["batch"],
                     "samples": chunks.width}}
    if trace:
        while gan.gen_opt.mini_step:  # the traced cycle starts at an optimizer step's first
            gan.training_step({"waveform": chunks.batch_at(i)})
            i += 1
        start = i

        def cycle():
            for j in range(start, start + accum):
                gan.training_step({"waveform": chunks.batch_at(j)})
                torch.cuda.synchronize()

        res["layer"]["trace"] = T.profile(torch, cycle)
        res["layer"]["micro_batches"] = accum
        core.log(f"traced {accum} micro-batches")
    res["memory_peak_bytes"] = peak
    del gan
    gc.collect()
    torch.cuda.empty_cache()

    ref_side = replay(cfg, *make_weights(cfg, seed, device), chunks, n_check)
    res["numbers"] = compare.train_numbers(prog, ref_side, accum)
    worst = res["numbers"].pop("worst")
    core.log(f"reference replayed {n_check} micro-batches; numbers {res['numbers']}; worst "
             f"leaves (name, program's norm, reference's): {worst}")
    return res


def replay(cfg: dict, w_g: dict, w_d: dict, chunks, n_check: int,
           prec: R.Precision = R.Precision.reference()) -> dict:
    """The reference's first ``n_check`` micro-batches on the window's rows: each
    one's (gen, disc) losses, the gradients of the first step, the change of
    every parameter."""
    step = GANStep(cfg, w_g, w_d, prec)
    with compare.no_tf32():
        losses = [step(chunks.batch_at(j)) for j in range(n_check)]
    out = {"losses": losses, "first_grad": {}, "delta": {}}
    for prefix, module, opt, start in (("generator", step.gen, step.opt_g, w_g),
                                       ("discriminator", step.disc, step.opt_d, w_d)):
        for k, p in module.named_parameters():
            out["first_grad"][f"{prefix}.{k}"] = opt.first_grad[k]
            out["delta"][f"{prefix}.{k}"] = p.detach() - start[k]
    return out
