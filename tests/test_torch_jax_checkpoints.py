"""The port reads what the JAX package writes, without JAX, orbax, tensorstore or
zstandard (``speechflow_torch.io.zstd``, ``io.ocdbt``, ``io.orbax`` and
``training.saver``), held here against the libraries the JAX package uses:

- zstd frames against ``zstandard``: levels, frames of many blocks, with and
  without a content size, streamed, back to back, and a truncated one;
- the OCDBT store against tensorstore's ``KvStore`` (list and read, byte for
  byte): orbax's stores at the top and under ``ocdbt.process_0``, and a store
  tensorstore writes with small nodes (a B-tree three levels deep, values
  stored apart from the nodes, more versions than the manifest holds inline);
- trees the JAX ``ExperimentSaver`` writes, read bit for bit as its own loader
  reads them; zarr arrays of several chunks against tensorstore's zarr driver;
  a corrupt node or manifest refused by its checksum;
- the toy program (``bench.build_toy``'s widths) saved by JAX and served by the
  port; the committed fixture ``tests/data/jax_checkpoints``
  (``tests/make_jax_checkpoints.py``) read as JAX reads it, and its sentence
  served on the CPU as JAX recorded it.
"""

import pickle
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import tensorstore as ts
import torch
import zstandard
from flax import nnx

from speechflow_torch.convert import load_nnx_state
from speechflow_torch.io import zstd
from speechflow_torch.io.ocdbt import OcdbtStore
from speechflow_torch.io.orbax import read_tree, read_zarr
from speechflow_torch.training.optimizer import OptimizerConfig, build_optimizer
from speechflow_torch.training.saver import ExperimentSaver, load_pickle
from speechflow_tpu.training.saver import ExperimentSaver as JSaver

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "data" / "jax_checkpoints"
# orbax 0.11 splits an array into chunks only past its OCDBT target data file size,
# 2 GiB (_DEFAULT_OCDBT_TARGET_DATA_FILE_SIZE); ExperimentSaver sets neither that nor a
# chunk size, so at any size a test can write each leaf is one chunk. Arrays of several
# chunks are written here with tensorstore's zarr driver on the same OCDBT store.
ORBAX_SPLIT_BYTES = 2 ** 31


# -- zstd --------------------------------------------------------------------------


def _payload(rng, n: int) -> bytes:
    """Compressible bytes: runs and small values."""
    return bytes(np.repeat(rng.integers(0, 8, max(n // 4, 1), dtype=np.uint8), 4)[:n])


@pytest.mark.parametrize("n", [0, 1, 1000, 131072 * 3 + 17])
@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_frames_decode_as_zstandard(n, level):
    """Frames with and without a content size, streamed, back to back; the
    largest holds several 128 KiB blocks."""
    raw = _payload(np.random.default_rng(n + level), n)
    with_size = zstandard.ZstdCompressor(level=level).compress(raw)
    no_size = zstandard.ZstdCompressor(level=level, write_content_size=False).compress(raw)
    cobj = zstandard.ZstdCompressor(level=level).compressobj()
    streamed = cobj.compress(raw) + cobj.flush()
    for frame in (with_size, no_size, streamed):
        assert zstd.decompress(frame) == zstandard.ZstdDecompressor().decompressobj().decompress(
            frame) == raw
    assert zstd.decompress(with_size + no_size) == raw + raw


def test_zstd_refuses_corrupt_frames():
    raw = _payload(np.random.default_rng(0), 50000)
    for frame in (zstandard.ZstdCompressor().compress(raw),
                  zstandard.ZstdCompressor(write_content_size=False).compress(raw)):
        with pytest.raises(ValueError, match="zstd"):
            zstd.decompress(frame[:-7])
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"PK\x03\x04 not zstd")


# -- OCDBT ---------------------------------------------------------------------------


def _assert_store_equal(root: Path) -> int:
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()
    keys = kv.list().result()
    store = OcdbtStore(root)
    assert store.keys() == sorted(keys)
    for k in keys:
        assert store.read(k) == kv.read(k).result().value, k
    with pytest.raises(KeyError):
        store.read(b"\xff not a key")
    return len(keys)


def _jax_tree(rng) -> dict:
    """Nested dicts, int keys, a list, f32, bf16, int32, bool, None, an empty dict, an
    optax AdamW state, and leaves enough for a few hundred keys (orbax's nodes hold up
    to 100 MB, so these stay one leaf node: the store of small nodes below is where
    interior nodes are read)."""
    model = {"embed": {"embedding": rng.normal(size=(40, 8)).astype(np.float32)},
             "blocks": {i: {"w": rng.normal(size=(8, 8)).astype(np.float32),
                            "mask": rng.random(8) > 0.5,
                            "ids": rng.integers(-5, 5, (3, 2)).astype(np.int32)}
                        for i in range(40)},
             "half": jnp.asarray(rng.normal(size=(5, 3)), jnp.bfloat16),
             "stack": [np.ones(3, np.float32), {"b": np.zeros((), np.float32)}],
             "none": None, "empty": {}}
    params = {"w": jnp.asarray(rng.normal(size=(4, 3)), jnp.float32)}
    opt = optax.adamw(1e-3).init(params)
    return {"model": model, "opt": opt}


def test_orbax_stores_read_as_tensorstore(tmp_path):
    """The top store and the process's store of a JAX ``ExperimentSaver``
    checkpoint: every key and value; and an OCDBT store of small nodes."""
    tree = _jax_tree(np.random.default_rng(0))
    path = JSaver(tmp_path, "t").save(3, tree["model"], opt_state=tree["opt"])
    assert _assert_store_equal(path) > 200
    assert _assert_store_equal(path / "ocdbt.process_0") > 200

    root = tmp_path / "small_nodes"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": {"max_decoded_node_bytes": 400,
                                     "max_inline_value_bytes": 16}}).result()
    for i in range(3):  # a B-tree of several levels in one commit
        with ts.Transaction() as txn:
            for j in range(100):
                kv.with_transaction(txn)[f"r{i}/key{j:03d}/x"] = bytes([j]) * (j % 40)
    for j in range(20):  # more versions than the manifest keeps inline (16)
        kv[f"late/{j}"] = bytes([j]) * 30
    assert _assert_store_equal(root) == 320
    assert OcdbtStore(root)._root_height >= 2


def _flip(path: Path, offset: int) -> None:
    data = bytearray(path.read_bytes())
    data[offset] ^= 0x40
    path.write_bytes(bytes(data))


def test_a_bad_checksum_raises(tmp_path):
    path = JSaver(tmp_path, "t").save(1, {"w": np.ones((4, 4), np.float32)})
    node = max((path / "d").iterdir(), key=lambda p: p.stat().st_size)
    _flip(node, 20)
    with pytest.raises(ValueError, match="CRC-32C"):
        OcdbtStore(path).keys()
    _flip(path / "manifest.ocdbt", 20)
    with pytest.raises(ValueError, match="CRC-32C"):
        OcdbtStore(path)


# -- trees ------------------------------------------------------------------------------


def _assert_same(ours, ref, path="") -> None:
    """Bit for bit, with the containers and key types JAX's loader returns."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and set(ours) == set(ref), (path, ours, ref)
        for k in ref:
            _assert_same(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(ours, list) and len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray) and ref.dtype == ml_dtypes.bfloat16:
        assert isinstance(ours, torch.Tensor) and ours.dtype == torch.bfloat16, path
        assert tuple(ours.shape) == ref.shape, path
        np.testing.assert_array_equal(ours.view(torch.int16).numpy(), ref.view(np.int16))
    elif isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray) and ours.dtype == ref.dtype, (path, ours)
        assert ours.shape == ref.shape, path
        np.testing.assert_array_equal(ours.view(np.uint8) if ours.ndim else ours,
                                      ref.view(np.uint8) if ref.ndim else ref, err_msg=path)
    else:
        assert type(ours) is type(ref) and ours == ref, (path, ours, ref)


def test_jax_saver_trees_read_bit_for_bit(tmp_path):
    """The tree and payload of a JAX checkpoint (with optax state) as the JAX
    loader returns them; it is resumable (it holds optimizer state), and a port
    optimizer refuses its tree by name, optax's raw AdamW tuple not being the
    ``nnx.Optimizer`` state a JAX trainer saves (``test_torch_jax_resume`` maps
    those)."""
    tree = _jax_tree(np.random.default_rng(1))
    saver = JSaver(tmp_path, "t")
    saver.to_save["pipeline_info"] = {"alphabet": ["a", "b"], "singletons": {"x": {1: 2}}}
    path = saver.save(7, tree["model"], opt_state=tree["opt"], extra={"word_lm_vocab": {"a": 1}})
    ref, ref_payload = JSaver.load_checkpoint(path)
    ours, payload = ExperimentSaver.load_checkpoint(path)
    _assert_same(ours, ref)
    assert payload == ref_payload and ours["step"].shape == () and int(ours["step"]) == 7
    assert ExperimentSaver.resumable(path) == path
    opt = build_optimizer(OptimizerConfig(), torch.nn.Linear(4, 3))
    with pytest.raises(KeyError, match="opt_state"):
        opt.load_state_dict({"opt_state": ours["opt"]})


@pytest.mark.parametrize("separator,order", [(".", "C"), ("/", "F")])
def test_zarr_arrays_of_several_chunks(tmp_path, separator, order):
    """A zarr v2 array on an OCDBT store, chunked 3 x 5 over 7 x 11 (edge chunks
    padded) with one chunk never written (the fill value), zstd and raw chunks,
    read as tensorstore reads it."""
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    want = np.arange(77, dtype=np.float32).reshape(7, 11) - 30.5
    for name, comp in (("z", {"id": "zstd", "level": 3}), ("raw", None)):
        spec = {"driver": "zarr", "kvstore": dict(base, path=f"{name}/"),
                "metadata": {"shape": [7, 11], "chunks": [3, 5], "dtype": "<f4",
                             "compressor": comp, "order": order, "fill_value": 2.5,
                             "dimension_separator": separator}, "create": True}
        arr = ts.open(spec).result()
        arr[:6, :].write(want[:6]).result()  # the last chunk row stays unwritten
        ref = arr.read().result()
        assert ref[6, 0] == 2.5
        got = read_zarr(OcdbtStore(tmp_path), name)
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == np.float32 and got.shape == (7, 11)
    assert ORBAX_SPLIT_BYTES == 2 ** 31


def test_unsupported_layouts_raise_by_name(tmp_path):
    import json

    path = JSaver(tmp_path, "t").save(1, {"w": np.ones(3, np.float32)})
    meta = json.loads((path / "_METADATA").read_text())
    (path / "_METADATA").write_text(json.dumps(dict(meta, use_zarr3=True)))
    with pytest.raises(ValueError, match="use_zarr3"):
        read_tree(path)


class _Marker:
    pass


def test_payload_classes_of_the_jax_package_map_to_the_port():
    """A payload naming a class under ``speechflow_tpu`` unpickles to the port's
    class of the same module path; one the port lacks raises by name."""
    from speechflow_torch.interface.tts_interface import TTSOptions

    data = pickle.dumps({"opts": _Marker()}, protocol=0).replace(
        b"tests.test_torch_jax_checkpoints", b"speechflow_tpu.interface.tts_interface"
    ).replace(b"_Marker", b"TTSOptions")
    assert isinstance(load_pickle(data)["opts"], TTSOptions)
    missing = data.replace(b"TTSOptions", b"NoSuchThing")
    with pytest.raises(pickle.UnpicklingError, match="NoSuchThing"):
        load_pickle(missing)


# -- programs -----------------------------------------------------------------------


def test_toy_program_saved_by_jax_serves_on_the_port(tmp_path, rng):
    """``bench.build_toy``'s widths (one layer a stack, 4 Euler steps): the JAX
    models saved by the JAX saver, loaded by the port's, give JAX's output."""
    from speechflow_torch import serving
    from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams
    from speechflow_torch.models.vocoder import Vocos, VocosParams
    from speechflow_tpu.models.vocoder import Vocos as JV
    from speechflow_tpu.models.vocoder import VocosParams as JVP
    from tests.torch_parity import (
        cfm_noise,
        jax_tts_input,
        jax_tts_model,
        n,
        randomize,
        t,
        torch_tts_input,
        tts_arrays,
    )

    ap = dict(serving.TOY_TTS_PARAMS, encoder_layers=1, decoder_layers=1, cfm_n_timesteps=4,
              max_output_length=40)
    vp = dict(serving.TOY_VOCODER_PARAMS, n_layers=1)
    jam = jax_tts_model(ap)
    jvm = randomize(JV(JVP(**vp), rngs=nnx.Rngs(1)))
    path = JSaver(tmp_path, "toy").save(1, {"am": nnx.to_pure_dict(nnx.state(jam, nnx.Param)),
                                            "vm": nnx.to_pure_dict(nnx.state(jvm, nnx.Param))})
    tree = ExperimentSaver.load_checkpoint(path)[0]["model"]
    am = load_nnx_state(ParallelTTSModel(ParallelTTSParams.create(ap)), tree["am"]).eval()
    vm = load_nnx_state(Vocos(VocosParams.create(vp)), tree["vm"]).eval()

    b, n_tok, t_out = 2, 11, ap["max_output_length"]
    arrays = tts_arrays(rng, b, n_tok, [n_tok, 8], n_symbols=100, n_speakers=8, n_langs=1)
    noise = cfm_noise(jam, (b, t_out, ap["n_mels"]))
    ref = jam(jax_tts_input(arrays), training=False, t_out=t_out)
    ref_wav = n(jvm({"mel": ref.spectrogram[-1]}))
    wav = n(serving.synthesize(am, vm, torch_tts_input(arrays), t_out=t_out, noise=t(noise)))
    assert wav.shape == ref_wav.shape and np.abs(wav).max() > 1e-3
    np.testing.assert_allclose(wav, ref_wav, atol=2e-4)  # test_torch_toy's WAVE_TOL


@pytest.mark.parametrize("kind", ["tts", "vocoder"])
def test_committed_fixture_reads_as_jax_reads_it(kind):
    ckpt = ExperimentSaver.get_last_checkpoint(FIXTURE / kind)
    assert ckpt is not None and (ckpt / "_METADATA").is_file()
    ref, ref_payload = JSaver.load_checkpoint(ckpt)
    ours, payload = ExperimentSaver.load_checkpoint(ckpt)
    _assert_same(ours, ref)
    assert payload == ref_payload


def test_committed_fixture_serves_the_recorded_sentence_on_the_cpu(monkeypatch):
    """The fixture's checkpoints through the port's interfaces on the CPU, with the
    recorded durations injected: JAX's mel and waveform (``chip_smoke.py``'s
    ``jax_ckpt`` holds the card to the same record)."""
    from speechflow_torch.interface.tts_interface import TTSEvaluationInterface, TTSOptions
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.models.tts.predictors import TokenLevelDP

    ref = np.load(FIXTURE / "reference.npz")
    monkeypatch.setattr(TokenLevelDP, "to_durations", staticmethod(
        lambda log_d, lengths: torch.as_tensor(ref["durations"])))
    ckpt = ExperimentSaver.get_last_checkpoint(FIXTURE / "tts")
    ti = TTSEvaluationInterface.from_checkpoint(*ExperimentSaver.load_checkpoint(ckpt),
                                                ckpt_path=ckpt, device="cpu")
    vi = VocoderEvaluationInterface.from_checkpoint(*ExperimentSaver.load_checkpoint(
        ExperimentSaver.get_last_checkpoint(FIXTURE / "vocoder")), device="cpu")
    with torch.inference_mode():
        out = ti.synthesize(str(ref["sentence"]), lang="EN", speaker=str(ref["speaker"]),
                            opts=TTSOptions(t_out=int(ref["t_out"])))
        n = int(out.spectrogram_lengths[0])
        mel = out.after_postnet_spectrogram[0, :n]
        wav = vi.synthesize(mel).data
    np.testing.assert_array_equal(out.attention.sum(1).numpy(), ref["durations"])
    np.testing.assert_allclose(mel.numpy(), ref["mel"],
                               atol=2e-5 * np.abs(ref["mel"]).max())
    assert wav.shape == ref["wav"].shape
    np.testing.assert_allclose(wav, ref["wav"], atol=1e-4 * np.abs(ref["wav"]).max())
