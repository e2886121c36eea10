"""GAN trainer: alternating generator and discriminator steps (counterpart of
``speechflow_tpu/training/gan_trainer.py``).

Per micro-batch: the generator step differentiates the generator's losses
``gen_criterion(gen_out, disc, inputs, targets, step)`` with respect to the
generator alone (the discriminator's parameters stop requiring grad for the
step, so their ``.grad`` stays untouched and no graph is kept through them
but the input's); then, every ``disc_every`` micro-batches from
``disc_start_iter`` on, the discriminator step on the same batch reuses the
generator's output, detached, without running the generator again. Both
optimizers are ``training.optimizer`` chains (accumulation, clip, NaN guard).
With mixed precision the generator's call and every discriminator call run
under bf16 autocast, outputs cast to float32 before the losses. Spans
(``utils/profiler.py::span``): ``gan.step`` around a micro-batch; inside it
``gan.gen.forward`` (the generator's call and cast), ``gan.gen.loss`` (its
criterion and sum), ``gan.gen.backward``, ``gan.disc`` (the discriminator's
losses and backward), and each optimizer's ``optim.step`` beside them.

Validation: MCD, SI-SNR and the periodicity metrics of the generated against
the real waveform, wideband PESQ with ``evaluate_pesq``, and a MOS hook.
Checkpoints hold both models (the JAX pure-dict layout, ``generator`` and
``discriminator``) and both optimizer states.

``use_mesh``: data parallel over the process group's ranks, as ``Trainer``
has it (``trainer.data_parallel``), for both models and both optimizers; each
rank's micro-batch is its slice of the global one, and rank 0 alone writes.
"""

from __future__ import annotations

import contextlib
import logging
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from speechflow_torch.convert import load_nnx_state, nnx_from_module
from speechflow_torch.models.vocoder.model import split_output
from speechflow_torch.parallel import distributed as dist
from speechflow_torch.training.optimizer import OptimizerConfig, build_optimizer
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.training.trainer import (
    TrainerConfig,
    _cast_floats,
    _place,
    _sum_losses,
    autocast,
    batch_getter,
    data_parallel,
    ranks_mean,
    summary_writer,
)
from speechflow_torch.utils.profiler import span

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["GANTrainer"]


@contextlib.contextmanager
def frozen(module: nn.Module):
    """``module``'s parameters stop requiring grad inside the block."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


class GANTrainer:
    def __init__(self, generator: nn.Module, discriminator: nn.Module,
                 gen_criterion: tp.Callable, disc_criterion: tp.Callable,
                 batch_processor: tp.Callable,
                 gen_optimizer: tp.Optional[OptimizerConfig] = None,
                 disc_optimizer: tp.Optional[OptimizerConfig] = None,
                 config: tp.Optional[TrainerConfig] = None,
                 saver: tp.Optional[ExperimentSaver] = None,
                 disc_every: int = 1, disc_start_iter: int = 0,
                 tb_dir: tp.Optional[tp.Union[str, Path]] = None,
                 mos_hook: tp.Optional[tp.Callable] = None,
                 evaluate_pesq: bool = False):
        self.generator = generator
        self.discriminator = discriminator
        self.gen_criterion = gen_criterion
        self.disc_criterion = disc_criterion
        self.batch_processor = batch_processor
        self.cfg = config or TrainerConfig()
        self.saver = saver
        self.disc_every = disc_every
        self.disc_start_iter = disc_start_iter
        self.mos_hook = mos_hook
        self.evaluate_pesq = evaluate_pesq
        self.global_step = 0
        self.gen_opt = build_optimizer(gen_optimizer or OptimizerConfig(method="adamw", lr=2e-4),
                                       generator)
        self.disc_opt = build_optimizer(disc_optimizer or OptimizerConfig(method="adamw",
                                                                          lr=2e-4),
                                        discriminator)
        self.mesh = data_parallel(self.cfg, [generator, discriminator],
                                  [self.gen_opt, self.disc_opt])
        self._tb = summary_writer(tb_dir)
        self.device = next(generator.parameters()).device

    def _autocast(self):
        return autocast(self.device, self.cfg.mixed_precision)

    def _disc(self, wav: torch.Tensor):
        """The discriminator under the trainer's precision, outputs in float32."""
        with self._autocast():
            out = self.discriminator(wav)
        return _cast_floats(out, torch.float32)

    def training_step(self, batch) -> tp.Dict[str, torch.Tensor]:
        """One generator (+ discriminator) micro-batch; returns {name: detached
        0-d tensor}."""
        self.generator.train()
        self.discriminator.train()
        with span("gan.step"):
            inputs, targets = _place(self.batch_processor(batch), self.device)
            step = self.global_step
            with dist.data_parallel_step(self.mesh is not None):
                gen_out, metrics = self._generator_step(inputs, targets, step)
                if step >= self.disc_start_iter and step % self.disc_every == 0:
                    fake = split_output(gen_out)[0]
                    metrics.update(self._discriminator_step(fake.detach(), inputs, targets,
                                                            step))
        self.global_step += 1
        return ranks_mean(metrics) if self.mesh is not None else metrics

    def _generator_step(self, inputs, targets, step: int):
        """Gradients of the generator's losses for the generator alone, then
        its optimizer; returns (the generator's float32 output, metrics)."""
        with frozen(self.discriminator):
            with span("gan.gen.forward"):
                with self._autocast():
                    gen_out = self.generator(inputs)
                gen_out = _cast_floats(gen_out, torch.float32)
            with span("gan.gen.loss"):
                losses = self.gen_criterion(gen_out, self._disc, inputs, targets, step)
                total = _sum_losses(losses)
            with span("gan.gen.backward"):
                total.backward()
        self.gen_opt.step()
        metrics = {f"gen/{k}": v.detach() for k, v in losses.items()}
        metrics["gen/total"] = total.detach()
        return gen_out, metrics

    def _discriminator_step(self, gen_out, inputs, targets, step: int):
        """The discriminator's losses on the (detached) generator output and
        the real waveform, then its optimizer; returns the metrics."""
        with span("gan.disc"):
            losses = self.disc_criterion(gen_out, self._disc, inputs, targets, step)
            total = _sum_losses(losses)
            total.backward()
        self.disc_opt.step()
        metrics = {f"disc/{k}": v.detach() for k, v in losses.items()}
        metrics["disc/total"] = total.detach()
        return metrics

    @torch.no_grad()
    def validation_step(self, batch) -> tp.Dict[str, float]:
        """MCD, SI-SNR, periodicity (and PESQ-WB, MOS) of one validation batch."""
        from speechflow_torch.models.vocoder.metrics import (
            mel_cepstral_distortion,
            periodicity_metrics,
            si_snr,
        )

        self.generator.eval()
        inputs, targets = _place(self.batch_processor(batch), self.device)
        with self._autocast():
            out = self.generator(inputs)
        fake = split_output(out)[0].float().cpu().numpy()
        real = targets["waveform"].float().cpu().numpy()
        t = min(fake.shape[-1], real.shape[-1])
        fake, real = fake[..., :t], real[..., :t]
        sr = getattr(getattr(self.generator, "params", None), "sample_rate", 24000)
        metrics = {"val/mcd": mel_cepstral_distortion(fake, real, sr),
                   "val/si_snr": si_snr(fake, real)}
        metrics.update({f"val/{k}": float(v)
                        for k, v in periodicity_metrics(fake, real, sr).items()})
        if self.evaluate_pesq:
            from speechflow_torch.models.vocoder.pesq import pesq_wb

            metrics["val/pesq_wb"] = float(np.mean(
                [pesq_wb(r, f, sr) for r, f in zip(real, fake)]))
        if self.mos_hook is not None:
            mos = [m for m in (self.mos_hook(f, sr) for f in fake) if m is not None]
            if mos:
                metrics["val/mos"] = float(np.mean(mos))
        if self.mesh is not None:
            metrics = {k: float(v) for k, v in ranks_mean(metrics).items()}
        return metrics

    def validate(self, val_loader) -> tp.Dict[str, float]:
        get_next = batch_getter(val_loader)
        agg: tp.Dict[str, list] = {}
        for _ in range(self.cfg.val_batches):
            try:
                m = self.validation_step(get_next())
            except StopIteration:
                break  # an exhausted val loader ends validation, not training
            for k, v in m.items():
                agg.setdefault(k, []).append(v)
        return {k: float(np.mean(v)) for k, v in agg.items()}

    def fit(self, train_loader, val_loader=None,
            callbacks: tp.Sequence[tp.Callable] = ()) -> tp.Dict[str, float]:
        get_next = batch_getter(train_loader)
        last: dict = {}
        t0 = time.time()
        while self.global_step < self.cfg.max_steps:
            last = self.training_step(get_next())
            s = self.global_step
            for cb in callbacks:
                cb(self, last)
            if s % self.cfg.log_every == 0:
                LOGGER.info("gan step %d: %s (%.2f it/s)", s,
                            {k: round(float(v), 4) for k, v in last.items()},
                            s / max(time.time() - t0, 1e-9))
                self._log_tb(last, s)
            if val_loader is not None and s % self.cfg.val_every == 0:
                vm = self.validate(val_loader)
                LOGGER.info("gan val @ %d: %s", s, {k: round(v, 4) for k, v in vm.items()})
                self._log_tb(vm, s)
                last.update(vm)
            if self.saver is not None and s % self.cfg.ckpt_every == 0:
                self.save_checkpoint()
        if self.saver is not None:
            self.save_checkpoint()
        return {k: float(v) for k, v in last.items()}

    def _log_tb(self, metrics: tp.Mapping, step: int) -> None:
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    # -- persistence ------------------------------------------------------------

    def warmstart_discriminator(self, expr_or_ckpt) -> None:
        """Only the discriminator's weights, from the last checkpoint of another
        experiment (its directory or its ``checkpoints`` directory)."""
        ckpt = ExperimentSaver.get_last_checkpoint(expr_or_ckpt)
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint under {expr_or_ckpt}")
        tree, _ = ExperimentSaver.load_checkpoint(ckpt)
        load_nnx_state(self.discriminator, tree["model"]["discriminator"])
        LOGGER.info("warm-started discriminator from %s", ckpt)

    def save_checkpoint(self, extra: tp.Optional[dict] = None) -> tp.Optional[Path]:
        """Rank 0 writes (the ranks' states are equal)."""
        if self.saver is None or dist.process_index() != 0:
            return None
        state = {"generator": nnx_from_module(self.generator),
                 "discriminator": nnx_from_module(self.discriminator)}
        opt_state = {"gen_opt": self.gen_opt.state_dict(),
                     "disc_opt": self.disc_opt.state_dict()}
        return self.saver.save(self.global_step, state, opt_state, extra=extra)

    def load_checkpoint(self, path) -> dict:
        """Both models, both optimizer states and the step."""
        tree, payload = ExperimentSaver.load_checkpoint(ExperimentSaver.resumable(path))
        load_nnx_state(self.generator, tree["model"]["generator"])
        load_nnx_state(self.discriminator, tree["model"]["discriminator"])
        opt_tree = tree.get("opt") or {}
        for opt, key in ((self.gen_opt, "gen_opt"), (self.disc_opt, "disc_opt")):
            if key in opt_tree:
                opt.load_state_dict(opt_tree[key])
        self.global_step = int(tree.get("step", 0))
        return payload
