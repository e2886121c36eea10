"""The port's handler registry and the handlers added to it, against the JAX
package's.

- ``get_handler`` resolves every name of JAX's registry, each with JAX's IO
  contract (``PipeRegistry.meta``: inputs, outputs, optional fields); in a fresh
  process it resolves ``lpc`` and ``apply_ssml_modifiers``, which JAX's raises
  ``KeyError`` for (ROADMAP §3).
- Each handler that is new in the port runs on two SEGS utterances that went
  through the debug data config's whole pipe in either package, with the same
  parameters; every field of the sample (the waveform, the frame- and
  token-level features, ``additional``) equals JAX's, bit for bit (both run the
  same numpy and scipy calls). Each augmentation at ``p=1`` with a seed, and at
  ``p=0`` as the identity.
- An unseeded augmentation draws from ``hash((uid, index))``, as in JAX: the same
  draw as JAX's and in every epoch within a process, other draws in a process
  with another hash seed (ROADMAP §3).
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from speechflow_torch.data.core.components import DataPipeline
from speechflow_torch.data.core.registry import PipeRegistry
from speechflow_torch.data.processors import HANDLERS, get_handler
from speechflow_torch.data.processors.singletons import StatisticsRange
from speechflow_torch.scripts.train_tts import configs

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
SEGS = "tests/data/SEGS"
NEW_HANDLERS = (
    "resample_audio", "preemphasis_audio", "loudness_normalize", "mu_law_encode_audio",
    "dither_audio", "spectral_flatness", "spectral_tilt", "spectral_envelope",
    "signal_enhancement", "clip", "normalize", "average_by_time", "pitch_to_wavelet",
    "timedim_interpolation", "store_field", "lpc", "lpc_from_spectrogram", "lpc_decompose",
    "calc_word_lengths", "apply_fade_inside_pauses", "calc_invert_durations",
    "transcription_by_frames", "apply_ssml_modifiers")
AUGMENTATIONS = (
    ("aug_gain", {}), ("aug_clipping", {}), ("aug_colored_noise", {"color": "pink"}),
    ("aug_pitch_shift", {}), ("aug_time_stretch", {}), ("aug_gain_curve", {}),
    ("aug_frequency_mask", {}), ("aug_gsm_simulation", {}), ("aug_vtlp", {}),
    ("aug_room_impulse_response", {}), ("aug_background_noise", {}),
    ("aug_change_rhythm", {"mode": "parabola"}), ("aug_monotonic_speech", {}),
    ("aug_spec_blur", {}), ("aug_spec_noise", {}), ("aug_spec_augment", {}))
RANGES = {"LJSpeech": {"pitch": [90.0, 310.0, 180.0, 40.0], "energy": [0.5, 90.0, 20.0, 15.0]},
          "p225": {"pitch": [120.0, 400.0, 220.0, 50.0], "energy": [0.3, 70.0, 12.0, 9.0]}}
# (handler, parameters): every new handler once, the ones with modes once a mode
CASES = [
    ("resample_audio", {"sample_rate": 16000}), ("preemphasis_audio", {"coeff": 0.95}),
    ("loudness_normalize", {"target_dbfs": -20.0}), ("mu_law_encode_audio", {"mu": 127}),
    ("dither_audio", {"amount": 1e-3, "seed": 3}),
    ("spectral_flatness", {}), ("spectral_tilt", {}),
    ("spectral_envelope", {"cutoff": 4, "n_bins": 40}),
    ("signal_enhancement", {"attributes": "pitch", "interpolate_zeros": True, "smooth": True}),
    ("signal_enhancement", {"attributes": ["pitch", "energy"], "interpolate_zeros": True,
                            "max_zero_interval": 8, "set_zero_in_pauses": True}),
    ("clip", {"attributes": ["pitch", "energy"], "min_value": 100.0, "max_value": 300.0}),
    ("normalize", {"attributes": ["pitch", "energy"]}),
    ("normalize", {"attributes": "pitch", "method": "quantile", "filter_outliers": True}),
    ("normalize", {"attributes": ["pitch", "energy"], "method": "z-norm"}),
    ("normalize", {"attributes": "energy", "normalize_by": "constant", "min_value": 0.0,
                   "max_value": 100.0}),
    ("normalize", {"attributes": ["pitch", "energy"], "normalize_by": "speaker"}),
    ("average_by_time", {"attributes": ["pitch", "energy", "rate"], "use_quantile": True}),
    ("average_by_time", {"attributes": ["pitch", "energy"], "min_value": 0.0}),
    ("pitch_to_wavelet", {"num_bands": 12}),
    ("timedim_interpolation", {"features": ["pitch", "energy"], "ratio": 0.5}),
    ("timedim_interpolation", {"features": "pitch", "mode": "nearest", "ratio": 1.5}),
    ("store_field", {"key": "mel", "as_key": "mel_before"}),
    ("lpc", {"order": 12}), ("lpc_from_spectrogram", {"order": 16}),
    ("lpc_decompose", {"order": 8, "frame_length": 512}),
    ("calc_word_lengths", {}), ("apply_fade_inside_pauses", {}),
    ("calc_invert_durations", {}), ("transcription_by_frames", {}),
    ("apply_ssml_modifiers", {}),
]


@pytest.fixture(scope="module")
def processed():
    """Two utterances (LJSpeech, p225) through the debug data config's pipe, in
    each package (JAX's feature cache off)."""
    from speechflow_tpu.data.core.components import DataPipeline as JDP
    from speechflow_tpu.data.core.singleton import Singleton
    from speechflow_tpu.io import Config

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SFTPU_DUMP_CACHE", raising=False)
        _, cfg = configs("debug", data_root=SEGS)
        try:
            jdp = JDP(Config(copy.deepcopy(cfg))).init_components()
            pdp = DataPipeline.from_config(cfg)
            out = []
            for i in (0, 3):
                j = jdp["train"].data_processor.process_sample(jdp["train"].dataset[i].copy())
                p = pdp.process.sample(pdp.datasets["train"][i])
                assert j.file_path == p.file_path
                out.append((j, p))
        finally:
            Singleton.clear()  # JAX's singletons are one instance per process and thread
    return out


def _same(a, b, what: str) -> None:
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(b, dict):
        assert set(a) == set(b), what
        for k in b:
            _same(a[k], b[k], f"{what}[{k}]")
    elif hasattr(b, "intervals"):
        np.testing.assert_array_equal(a.intervals, b.intervals, err_msg=what)
    elif hasattr(b, "waveform") and hasattr(b, "sr"):
        assert a.sr == b.sr, what
        _same(a.data, b.data, f"{what}.data")
    elif isinstance(b, (list, tuple)) and b and isinstance(b[0], tuple):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            assert x[0] == y[0], what
            _same(x[1], y[1], what)
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def assert_same_sample(p, j) -> None:
    """Every field of the port's sample (and ``additional``) equals JAX's."""
    for name in p.__dataclass_fields__:
        if hasattr(j, name) and name != "transform_params":
            _same(getattr(p, name), getattr(j, name), name)
    _same(p.additional, j.additional, "additional")


def _ssml(ds):
    """SSML words and modifiers for ``apply_ssml_modifiers``: the sample's words,
    the second and third in a slow, high span."""
    from speechflow_torch.data.processors.ssml import parse_ssml

    words = (ds.text or "").split()
    text = " ".join(words[:1] + ['<prosody rate="slow" pitch="high">'] + words[1:3]
                    + ["</prosody>"] + words[3:])
    return parse_ssml(text)[1]


def _run(name, kwargs, j, p):
    from speechflow_tpu.data.processors import get_handler as jget
    from speechflow_tpu.data.core.singleton import Singleton
    from speechflow_tpu.data.processors import lpc, ssml  # noqa: F401  (not imported by jget)
    from speechflow_tpu.data.processors.singletons import StatisticsRange as JRange

    j, p = j.copy(), copy.deepcopy(p)
    jk, pk = dict(kwargs), dict(kwargs)
    if kwargs.get("normalize_by") == "speaker":
        jr, pr = JRange(), StatisticsRange()
        jr.ranges, pr.ranges = copy.deepcopy(RANGES), copy.deepcopy(RANGES)
        jk["ranges"], pk["ranges"] = jr, pr
    if name == "apply_ssml_modifiers":
        j.additional["ssml"] = p.additional["ssml"] = _ssml(p)
        j.word_lengths = p.word_lengths = np.asarray(
            [1] * (len(p.additional["ssml"]) - 1) + [p.n_tokens - len(p.additional["ssml"]) + 1],
            np.int32)
    try:
        return jget(name)(j, **jk), get_handler(name)(p, **pk)
    finally:
        Singleton.clear(JRange)


@pytest.mark.parametrize("sample", [0, 1], ids=["LJSpeech", "p225"])
@pytest.mark.parametrize("name,kwargs", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_new_handler_matches_jax(processed, name, kwargs, sample):
    j, p = _run(name, kwargs, *processed[sample])
    assert_same_sample(p, j)


def test_every_new_handler_has_a_case():
    assert {n for n, _ in CASES} == set(NEW_HANDLERS)


@pytest.mark.parametrize("name,kwargs", AUGMENTATIONS, ids=[n for n, _ in AUGMENTATIONS])
@pytest.mark.parametrize("p_apply", [1.0, 0.0])
def test_augmentation_matches_jax(processed, name, kwargs, p_apply):
    """Seeded, at ``p=1`` (the sample changes) and ``p=0`` (the identity)."""
    j0, p0 = processed[0]
    j, p = _run(name, dict(kwargs, p=p_apply, seed=7), j0, p0)
    assert_same_sample(p, j)
    field = "mel" if name.startswith("aug_spec") else "audio_chunk"
    before, after = getattr(p0, field), getattr(p, field)
    before, after = (before.data, after.data) if field == "audio_chunk" else (before, after)
    changed = before.shape != after.shape or not np.array_equal(before, after)
    assert changed == (p_apply == 1.0)


def test_augmentation_files_load_through_the_port(processed, tmp_path):
    """Measured impulse responses and noise files (WAV and Ogg/Vorbis) are read
    by the port's ``AudioChunk``."""
    from speechflow_torch.io.audio import AudioChunk

    rng = np.random.default_rng(0)
    ir = (rng.standard_normal(2400) * np.exp(-np.arange(2400) / 300)).astype(np.float32)
    AudioChunk(data=0.5 * ir / np.abs(ir).max(), sr=24000).save(tmp_path / "ir.wav")
    AudioChunk(data=0.1 * rng.standard_normal(30000).astype(np.float32),
               sr=16000).save(tmp_path / "noise.ogg")
    for name, kw in (("aug_room_impulse_response", {"ir_paths": [str(tmp_path / "ir.wav")]}),
                     ("aug_background_noise",
                      {"background_paths": [str(tmp_path / "noise.ogg")]})):
        j, p = _run(name, dict(kw, p=1.0, seed=1), *processed[0])
        assert_same_sample(p, j)


def test_registry_metadata_equals_jax():
    """All 67 names, each with JAX's inputs, outputs and optional fields."""
    from speechflow_tpu.data.core.registry import PipeRegistry as JReg
    from speechflow_tpu.data.processors import HANDLERS as JHANDLERS
    from speechflow_tpu.data.processors import get_handler as jget
    from speechflow_tpu.data.processors import lpc, ssml  # noqa: F401

    jget("load_audio")
    get_handler("load_audio")
    assert len(JHANDLERS) == 67 and set(HANDLERS) == set(JHANDLERS)
    for name, fn in JHANDLERS.items():
        ours, ref = PipeRegistry.meta(get_handler(name)), JReg.meta(fn)
        assert {k: ours[k] for k in ("name", "inputs", "outputs", "optional")} == \
            {k: ref[k] for k in ("name", "inputs", "outputs", "optional")}, name


def test_pipe_registry_check_and_filter_match_jax(processed):
    """``check`` and ``filter`` over the debug pipe with the contour handlers,
    against JAX's on the same names."""
    from speechflow_tpu.data.core.registry import PipeRegistry as JReg
    from speechflow_tpu.data.processors import get_handler as jget

    _, cfg = configs("debug")
    names = list(cfg["preproc"]["pipe"])
    names[names.index("aggregate_pitch"):names.index("aggregate_pitch")] = [
        "signal_enhancement", "average_by_time", "normalize", "calc_invert_durations"]
    ours, ref = [get_handler(n) for n in names], [jget(n) for n in names]
    init = {"audio_chunk", "phonemes", "phoneme_timestamps", "text"}
    assert PipeRegistry.check(ours, init) and JReg.check(ref, init)
    for fields in ({"text"}, {"audio_chunk"}):
        with pytest.raises(ValueError) as a:
            PipeRegistry.check(ours, fields)
        with pytest.raises(ValueError) as b:
            JReg.check(ref, fields)
        assert str(a.value) == str(b.value)
    for kw in (dict(drop_names={"pitch", "energy"}), dict(drop_fields={"durations"}),
               dict(before="calc_durations"), dict(after="normalize")):
        assert [PipeRegistry.meta(f)["name"] for f in PipeRegistry.filter(ours, **kw)] == \
            [JReg.meta(f)["name"] for f in JReg.filter(ref, **kw)]


def _fresh(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=env)


FRESH_NAMES = ("lpc", "lpc_from_spectrogram", "lpc_decompose", "apply_ssml_modifiers")
_LOOKUP = ("import os; os.environ['JAX_PLATFORMS'] = 'cpu'\n"
           "from {pkg}.data.processors import get_handler\n"
           "for name in {names!r}:\n"
           "    try:\n"
           "        print(name, get_handler(name).__name__)\n"
           "    except KeyError as e:\n"
           "        print(name, 'KeyError')\n")


@pytest.fixture(scope="module")
def fresh_lookups():
    """Each package's ``get_handler`` of ``FRESH_NAMES`` in a fresh process."""
    out = {}
    for pkg in ("speechflow_tpu", "speechflow_torch"):
        run = _fresh(_LOOKUP.format(pkg=pkg, names=FRESH_NAMES))
        assert run.returncode == 0, run.stderr[-2000:]
        out[pkg] = dict(line.split() for line in run.stdout.splitlines())
    return out


@pytest.mark.parametrize("name", FRESH_NAMES)
def test_fresh_process_resolves_what_jax_misses(fresh_lookups, name):
    """ROADMAP §3: JAX's ``get_handler`` imports neither ``lpc`` nor ``ssml``, so in a
    fresh process these names raise ``KeyError`` there; the port resolves them."""
    assert fresh_lookups["speechflow_tpu"][name] == "KeyError"
    assert fresh_lookups["speechflow_torch"][name] == name


_DRAW = ("from speechflow_torch.data.core.datasample import AudioDataSample\n"
         "from speechflow_torch.data.processors import get_handler\n"
         "from speechflow_torch.io.audio import AudioChunk\n"
         "import numpy as np\n"
         "ds = AudioDataSample(file_path='a.wav', index=3,\n"
         "                     audio_chunk=AudioChunk(data=np.ones(8, np.float32), sr=8000))\n"
         "print(float(get_handler('aug_gain')(ds, p=1.0).audio_chunk.data[0]))\n")


def test_unseeded_augmentation_is_frozen_per_process(processed):
    """ROADMAP §3: unseeded, ``aug_gain`` draws from ``hash((uid, index))``: in one
    process the port's draw equals JAX's and repeats in a second epoch; a process
    with another ``PYTHONHASHSEED`` (a loader worker, a rerun) draws another gain."""
    from speechflow_tpu.data.processors import get_handler as jget

    j0, p0 = processed[0]
    assert p0.uid == j0.uid
    gains = []
    for _ in range(2):  # two epochs over the same sample
        j = jget("aug_gain")(j0.copy(), p=1.0)
        p = get_handler("aug_gain")(copy.deepcopy(p0), p=1.0)
        assert_same_sample(p, j)
        gains.append(p.audio_chunk.data)
    np.testing.assert_array_equal(gains[0], gains[1])
    assert not np.array_equal(gains[0], p0.audio_chunk.data)

    draws = [_fresh(_DRAW, dict(os.environ, PYTHONHASHSEED=s)).stdout for s in ("1", "2")]
    assert draws[0] and draws[1] and draws[0] != draws[1]
