"""The toy serving program of the port (``serving.build_toy``) against the JAX
package's (``bench.build_toy``: CFM acoustic model -> mel -> Vocos with the
ISTFT head), f32 on the CPU at reduced depth and length with the same
weights and the same initial CFM noise: the predicted integer durations must
be equal, then the mel and the waveform agree. The port's toy presets are
held equal to ``bench.py``'s literals, read with ``ast`` (the port never
imports the bench)."""

import ast
from pathlib import Path

import numpy as np
import torch
from flax import nnx

from speechflow_torch import serving
from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams
from speechflow_torch.models.vocoder import Vocos, VocosParams
from tests.torch_parity import (
    cfm_noise,
    jax_tts_input,
    jax_tts_model,
    n,
    port,
    randomize,
    t,
    torch_tts_input,
    tts_arrays,
)

torch.set_num_threads(1)
MEL_TOL = 2e-4   # the whole acoustic model (test_torch_tts_model's MODEL_TOL)
WAVE_TOL = 2e-4  # that mel carried through the backbone and the ISTFT head
BENCH = Path(__file__).resolve().parent.parent / "bench.py"


def _bench_literals():
    """(toy_params, the VocosParams keywords) of ``bench.build_toy``, with the
    module constants they name resolved."""
    tree = ast.parse(BENCH.read_text())
    consts = {tgt.id: ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign) for tgt in node.targets
              if isinstance(tgt, ast.Name) and isinstance(node.value, ast.Constant)}

    def value(v):
        return consts[v.id] if isinstance(v, ast.Name) else ast.literal_eval(v)

    fn = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "build_toy")
    toy = vocoder = None
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "toy_params":
            toy = {k.arg: value(k.value) for k in node.value.keywords}
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "VocosParams":
            vocoder = {k.arg: value(k.value) for k in node.keywords}
    return toy, vocoder


def test_toy_presets_equal_the_bench_literals():
    toy, vocoder = _bench_literals()
    assert serving.TOY_TTS_PARAMS == toy
    assert serving.TOY_VOCODER_PARAMS == vocoder
    am, vm = serving.build_toy(device="cpu", dtype=torch.float32, seed=0)
    assert (am.p.encoder_dim, am.p.encoder_heads, am.p.decoder_type, am.p.cfm_cfg_scale) == \
        (256, 4, "cfm", 0.0)
    assert type(vm.head).__name__ == "ISTFTHead" and vm.params.dim == 512


def test_toy_program_matches_jax(rng):
    from speechflow_tpu.models.vocoder import Vocos as JV
    from speechflow_tpu.models.vocoder import VocosParams as JVP

    # the toy's widths (256 and 512, 4 heads), cut to one layer per stack, 4 Euler
    # steps and 40 frames
    ap = dict(serving.TOY_TTS_PARAMS, encoder_layers=1, decoder_layers=1, cfm_n_timesteps=4,
              max_output_length=40)
    vp = dict(serving.TOY_VOCODER_PARAMS, n_layers=1)
    jam = jax_tts_model(ap)
    jvm = randomize(JV(JVP(**vp), rngs=nnx.Rngs(1)))
    am = port(ParallelTTSModel(ParallelTTSParams.create(ap)), jam)
    vm = port(Vocos(VocosParams.create(vp)), jvm)

    b, n_tok, t_out = 2, 11, ap["max_output_length"]
    arrays = tts_arrays(rng, b, n_tok, [n_tok, 8], n_symbols=100, n_speakers=8, n_langs=1)
    noise = cfm_noise(jam, (b, t_out, ap["n_mels"]))
    ref_out = jam(jax_tts_input(arrays), training=False, t_out=t_out)
    ref_mel = ref_out.spectrogram[-1]
    ref_wav = n(jvm({"mel": ref_mel}))  # the bench's call: the pass-through extractor

    with torch.inference_mode():
        out = am(torch_tts_input(arrays), t_out=t_out, noise=t(noise))
    durs = n(out.attention).sum(1)
    np.testing.assert_array_equal(durs, n(ref_out.attention).sum(1))
    assert durs.sum(1).max() < t_out
    valid = (np.arange(t_out)[None] < n(out.spectrogram_lengths)[:, None])[..., None]
    np.testing.assert_allclose(n(out.spectrogram[-1]) * valid, n(ref_mel) * valid,
                               atol=MEL_TOL)
    wav = n(serving.synthesize(am, vm, torch_tts_input(arrays), t_out=t_out, noise=t(noise)))
    assert wav.shape == ref_wav.shape == (b, (t_out - 1) * vp["hop_length"])
    np.testing.assert_allclose(wav, ref_wav, atol=WAVE_TOL)
    assert np.abs(wav).max() > 1e-3
