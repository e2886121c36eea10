"""The plain reference, at debug widths on the CPU, agrees with the port's plain
path (its kernels' CPU versions) fed the same weights and inputs, in float32."""

import debug_cells
import torch

from port_bench import compare
from port_bench.drivers import gan_train, serve
from port_bench.reference import nn as R
from port_bench.traffic import tts_text


def test_serving_reference_agrees_with_the_port():
    from speechflow_torch.models.tts import TTSForwardInput

    cell = debug_cells.serve_cell("cfm-bigvgan.b32-sentences")
    cfg = dict(cell.config, dtype="float32")
    params = cell.workload["traffic"]
    dev = torch.device("cpu")
    calls = tts_text.make_calls(params, 2 ** 31 + 3, cfg["acoustic_model"])
    weights = serve.make_weights(cfg, 2 ** 31 + 3, dev, calls, params["t_out"])
    am, vm = serve.build_program(cfg, weights, dev)
    ref_am, ref_voc = serve.reference_models(cfg, weights, dev)
    t_out = params["t_out"]
    for c in calls[:2]:
        noise = torch.randn(c.rows, t_out, cfg["acoustic_model"]["n_mels"],
                            generator=torch.Generator().manual_seed(1)) * 0.667
        with torch.inference_mode():
            out = am.inference(TTSForwardInput(**c.inputs), t_out=t_out, noise=noise)
            wav = vm.from_features(out.spectrogram[-1])
        prog = {"log_d": out.variance_predictions["durations"], "align": out.attention,
                "lengths": out.spectrogram_lengths, "mel": out.spectrogram[-1], "wave": wav}
        ref = ref_am(c.inputs, t_out, noise, R.Precision.reference())
        assert torch.equal(ref["lengths"], prog["lengths"])
        assert torch.equal(ref["align"], prog["align"])
        numbers = compare.serve_numbers(prog, c.inputs, noise, ref_am, ref_voc, t_out,
                                        cfg["vocoder"]["hop_length"])
        assert numbers["align_frames"] == 0
        for key in ("dur_gap", "mel_err", "wave_err"):
            assert numbers[key] < 1e-4, (key, numbers)


def test_gan_reference_agrees_with_the_port(monkeypatch):
    debug_cells.host_cuda(monkeypatch, torch)
    cell = debug_cells.gan_cell()
    cell.config["trainer"]["mixed_precision"] = False
    res = gan_train.run(cell, 2 ** 31 + 9, 0.2, False, torch.device("cpu"))
    n = res["numbers"]
    # float32 on both sides, sums in other orders (the reference's FIRs are
    # depthwise convolutions): rounding, grown where a LeakyReLU input sits near 0
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 5e-3 and n["delta_gap"] < 5e-3, n
