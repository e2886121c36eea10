"""The comparison that decides ``correct`` fails its control and the planted faults.

- The control: the reference in the program's place, computed in float8 e4m3
  (every product's operands, one scale a tensor) under bfloat16, the precision
  below the configuration's bfloat16. It has to fail one of a serving cell's
  numbers.
- The faults, each planted in the program underneath a run that skips the
  look for a card (debug widths on the CPU): a CFM whose Euler steps return
  the state unchanged, half of the batch left out, a token's duration altered
  where it is produced; in training, an optimizer step that leaves the
  parameters unchanged, half of the batch left out with the mean taken over
  the rest, the generator's waveform altered where it is produced. Each has to
  make ``correct`` false.

The tests marked ``cuda`` read the control and a dozen seeds of the program at
the cells' own sizes on the card and print each reading:
``python -m pytest --noconftest -p no:cacheprovider -s -m cuda port_bench/tests``.
"""

import gc

import debug_cells
import pytest
import torch

from port_bench import compare, core, run
from port_bench.drivers import gan_train, serve
from port_bench.reference import nn as R
from port_bench.traffic import audio_chunks, tts_text

SEEDS = (2 ** 31 + 17, 5, 906)


def _control_numbers(cell, seed, device):
    cfg, params = cell.config, cell.workload["traffic"]
    calls = tts_text.make_calls(params, seed, cfg["acoustic_model"])
    weights = serve.make_weights(cfg, seed, device, calls, params["t_out"])
    am, voc = serve.reference_models(cfg, weights, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for c in sorted(calls, key=lambda c: -sum(c.lengths))[:params["check_calls"]]:
        x = serve.to_device(c.inputs, device)
        noise = torch.randn((c.rows, params["t_out"], cfg["acoustic_model"]["n_mels"]),
                            generator=gen, device=device) * cfg["cfm_temperature"]
        prog = compare.serve_control(x, noise, am, voc, params["t_out"])
        out.append(compare.serve_numbers(prog, x, noise, am, voc, params["t_out"],
                                         cfg["vocoder"]["hop_length"]))
    return compare.merge(out)


@pytest.mark.parametrize("name", ["cfm-bigvgan.b32-long", "cfm-bigvgan.b32-sentences"])
def test_serving_control_fails(name):
    cell = debug_cells.serve_cell(name)
    for seed in SEEDS:
        ok, checks = compare.judge(_control_numbers(cell, seed, torch.device("cpu")),
                                   cell.workload["limits"])
        assert not ok, checks


def _gan_control_numbers(cell, seed, device):
    """The GAN reference replayed in the control's precision, judged against the
    reference replayed in float32, on the same rows."""
    cfg, params = cell.config, cell.workload["traffic"]
    accum = int(cfg["optimizer"]["grad_accum"])
    n_check = params["check_steps"] * accum
    chunks = audio_chunks.Chunks(dict(params, batch=cfg["batch"], **cfg["data"]), seed, device,
                                 core.ROOT)
    control = gan_train.replay(cfg, *gan_train.make_weights(cfg, seed, device), chunks,
                               n_check, R.Precision.control())
    ref = gan_train.replay(cfg, *gan_train.make_weights(cfg, seed, device), chunks, n_check)
    numbers = compare.train_numbers(control, ref, accum)
    numbers.pop("worst")
    return numbers


def test_training_control_fails():
    cell = debug_cells.gan_cell()
    for seed in SEEDS:
        ok, checks = compare.judge(_gan_control_numbers(cell, seed, torch.device("cpu")),
                                   cell.workload["limits"])
        assert not ok, checks


def _run(cell, monkeypatch):
    """A whole run but the look for a card: (correct, the numbers beside their limits)."""
    debug_cells.host_cuda(monkeypatch, torch)
    result, checks = run.execute(cell, SEEDS[0], 0.2, False, torch.device("cpu"))
    return result["correct"], checks


def _still(monkeypatch):
    from speechflow_torch.models.tts.decoders import CFMDecoder

    monkeypatch.setattr(CFMDecoder, "_dphi", lambda self, x_t, *a, **k: torch.zeros_like(
        x_t[..., :self.dim_out]))


def _half_rows(monkeypatch):
    from speechflow_torch.models.tts import ParallelTTSModel
    from speechflow_torch.models.tts.data_types import TTSForwardInput

    inference = ParallelTTSModel.inference

    def half(self, inputs, t_out=None, noise=None, **kw):
        b = inputs.transcription.shape[0]
        keep = torch.arange(b) % max(1, b // 2) if b > 1 else torch.arange(b)
        sub = TTSForwardInput(**{k: (v[keep] if isinstance(v, torch.Tensor) and v.ndim
                                     and v.shape[0] == b else v)
                                 for k, v in vars(inputs).items()})
        return inference(self, sub, t_out=t_out, noise=noise, **kw)

    monkeypatch.setattr(ParallelTTSModel, "inference", half)


def _token_altered(monkeypatch):
    from speechflow_torch.models.tts.predictors import TokenLevelDP

    to_durations = TokenLevelDP.to_durations

    def altered(log_d, lengths=None):
        d = to_durations(log_d, lengths)
        d[:, 0] += 1.0
        return d

    monkeypatch.setattr(TokenLevelDP, "to_durations", staticmethod(altered))


@pytest.mark.parametrize("fault", [_still, _half_rows, _token_altered])
def test_serving_faults_fail(fault, monkeypatch):
    cell = debug_cells.serve_cell("cfm-bigvgan.b32-sentences")
    cell.config["dtype"] = "float32"
    ok, checks = _run(cell, monkeypatch)
    assert ok, checks  # the sound run at these sizes passes
    fault(monkeypatch)
    ok, checks = _run(cell, monkeypatch)
    assert not ok, checks


def _optimizer_still(monkeypatch):
    from speechflow_torch.training.optimizer import Optimizer

    step = Optimizer.step

    def still(self):
        saved = [p.detach().clone() for p in self.params]
        out = step(self)
        with torch.no_grad():
            for p, s in zip(self.params, saved):
                p.copy_(s)
        return out

    monkeypatch.setattr(Optimizer, "step", still)


def _half_batch(monkeypatch):
    from speechflow_torch.models.vocoder.batch_processor import VocoderBatchProcessor

    call = VocoderBatchProcessor.__call__

    def half(self, batch):
        inputs, targets = call(self, batch)
        n = max(1, inputs["waveform"].shape[0] // 2)
        return {k: v[:n] for k, v in inputs.items()}, {k: v[:n] for k, v in targets.items()}

    monkeypatch.setattr(VocoderBatchProcessor, "__call__", half)


def _wave_altered(monkeypatch):
    from speechflow_torch.models.vocoder import Vocos

    forward = Vocos.forward

    def altered(self, inputs, *a, **k):
        wav = forward(self, inputs, *a, **k)
        return torch.cat([0.5 * wav[:1], wav[1:]], dim=0)

    monkeypatch.setattr(Vocos, "forward", altered)


class _Doubled(torch.autograd.Function):
    """The identity, whose gradient comes out doubled."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return 2.0 * g


def _snake_grad_doubled(monkeypatch):
    """The fused anti-alias entry's VJP returns twice the gradient of alpha (on
    the CPU, where the entry runs the plain path under autograd, the same)."""
    from speechflow_torch.ops import anti_alias

    vjp, plain = anti_alias.anti_alias_snake_vjp, anti_alias.anti_alias_snake_reference

    def doubled_vjp(*args, **kwargs):
        dx, d_alpha, d_beta = vjp(*args, **kwargs)
        return dx, 2.0 * d_alpha, d_beta

    def doubled_plain(x, alpha, beta, *args, **kwargs):
        return plain(x, _Doubled.apply(alpha), beta, *args, **kwargs)

    monkeypatch.setattr(anti_alias, "anti_alias_snake_vjp", doubled_vjp)
    monkeypatch.setattr(anti_alias, "anti_alias_snake_reference", doubled_plain)


@pytest.mark.parametrize("fault", [_optimizer_still, _half_batch, _wave_altered,
                                   _snake_grad_doubled])
def test_training_faults_fail(fault, monkeypatch):
    cell = debug_cells.gan_cell()
    cell.config["trainer"]["mixed_precision"] = False
    ok, checks = _run(cell, monkeypatch)
    assert ok, checks
    fault(monkeypatch)
    ok, checks = _run(cell, monkeypatch)
    assert not ok, checks


# -- readings at the cells' own sizes, on the card ------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cfm-bigvgan.b32-long", "cfm-bigvgan.b32-sentences"])
def test_serving_control_at_cell_size(name):
    device = _card()
    cell = core.Cell.load(name)
    oks = []
    for seed in SEEDS:
        numbers = _control_numbers(cell, seed, device)
        oks.append(compare.judge(numbers, cell.workload["limits"]))
        print(f"\n[control] {name} seed {seed}: {numbers}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    assert not any(ok for ok, _ in oks), oks


@pytest.mark.cuda
def test_training_control_at_cell_size():
    device = _card()
    cell = core.Cell.load("bigvgan-gan.b32-1s")
    oks = []
    for seed in SEEDS:
        numbers = _gan_control_numbers(cell, seed, device)
        oks.append(compare.judge(numbers, cell.workload["limits"]))
        print(f"\n[control] bigvgan-gan.b32-1s seed {seed}: {numbers}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    assert not any(ok for ok, _ in oks), oks


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [_half_batch, _wave_altered, _snake_grad_doubled])
def test_training_faults_at_cell_size(fault, monkeypatch):
    _card()
    cell = core.Cell.load("bigvgan-gan.b32-1s")
    oks = []
    for seed in SEEDS:
        fault(monkeypatch)
        res = gan_train.run(cell, seed, 1.0, False, torch.device("cuda"))
        oks.append(compare.judge(res["numbers"], cell.workload["limits"]))
        print(f"\n[fault] {fault.__name__} seed {seed}: {res['numbers']}", flush=True)
        monkeypatch.undo()
        gc.collect()
        torch.cuda.empty_cache()
    assert not any(ok for ok, _ in oks), oks
