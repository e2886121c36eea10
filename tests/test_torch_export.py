"""The port's serving entry points on the CPU: ``scripts/export.py`` (``pack``,
``InferenceBundle``, the ``speechflow-torch-export`` CLI) over checkpoints the
port's saver writes, and ``app/demo_server.py`` answering HTTP on a free port.

Narrow models with seeded weights stand in for trained ones: the acoustic
model of ``tests/torch_parity.tts_params`` (12 mel bins), a BigVGAN-kind
vocoder of ``vocoder_params`` over the same bins, and the XTTS debug recipe.
The bundle must serve what the interfaces serve when built from the same
checkpoints (bit for bit: the same draws, the same weights)."""

import dataclasses
import io
import json
import math
import tarfile
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from speechflow_torch import serving
from speechflow_torch.app.demo_server import T_OUT, make_server
from speechflow_torch.convert import nnx_from_module
from speechflow_torch.data.processors.text import Alphabet, TextParserHook
from speechflow_torch.interface.tts_interface import TTSEvaluationInterface, TTSOptions
from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
from speechflow_torch.interface.xtts_interface import XTTSEvaluationInterface
from speechflow_torch.models.prosody import ProsodyModel, ProsodyParams
from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams, XTTSModel, XTTSParams
from speechflow_torch.models.vocoder import Vocos, VocosParams
from speechflow_torch.scripts import export
from speechflow_torch.scripts.train_tts import configs
from speechflow_torch.training.saver import ExperimentSaver
from tests.torch_parity import tts_params, vocoder_params

torch.set_num_threads(1)
TEXT = "Hello world. A zebra dozed!"
SPEAKERS = {"amy": 0, "bob": 1, "cyd": 2}
OPTS = TTSOptions(t_out=64)


def _info(symbols) -> dict:
    return {"config": serving.TTS_DATA_CONFIG, "subsets": ["train", "test"],
            "alphabet": Alphabet(symbols).to_dict(),
            "singletons": {"SpeakerIDSetter": {"speaker2id": SPEAKERS,
                                               "lang2id": {"EN": 0, "RU": 1}}}}


def _save(root, name: str, model: torch.nn.Module, payload: dict):
    saver = ExperimentSaver(root, expr_suffix=name)
    saver.to_save.update(payload)
    saver.save(2, nnx_from_module(model))
    return saver.expr_path


@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    """{kind: experiment directory} of a TTS, a vocoder and an XTTS model."""
    root = tmp_path_factory.mktemp("experiments")
    symbols = sorted(set(TextParserHook()(TEXT + " abcdefghijklmnopqrstuvwxyz")))
    gen = torch.Generator().manual_seed(0)
    tp_ = tts_params(n_symbols=64)
    am = serving.init_random_(ParallelTTSModel(ParallelTTSParams.create(tp_)), gen)
    with torch.no_grad():
        am.variance_adaptor.predictors["durations"].out.bias.fill_(math.log1p(3.0))
    vp = VocosParams.create(vocoder_params(n_mels=tp_["n_mels"]))
    vm = serving.init_random_(Vocos(vp), gen)
    xp = dict(configs("debug", "configs/xtts_model.yml")[0]["model"], n_symbols=len(symbols) + 5, n_speakers=3,
              prompt_dim=100)
    torch.manual_seed(0)
    xm = XTTSModel(XTTSParams.create(xp))
    return {
        "tts": _save(root, "tts", am, {"model_params": dataclasses.asdict(am.p),
                                       "pipeline_info": _info(symbols)}),
        "vocoder": _save(root, "voc", vm, {"model_params": dataclasses.asdict(vp)}),
        "xtts": _save(root, "xtts", xm, {"model_params": xp, "pipeline_info": _info(symbols)}),
    }


@pytest.fixture(scope="module")
def bundle(experiments, tmp_path_factory):
    out = tmp_path_factory.mktemp("bundle") / "b.sftpu.tar.gz"
    export.pack(out, **experiments)
    return export.InferenceBundle.load(out, device="cpu")


def _interfaces(experiments):
    """The TTS and vocoder interfaces built straight from the experiments."""
    tts_ckpt = ExperimentSaver.get_last_checkpoint(experiments["tts"])
    tts = TTSEvaluationInterface.from_checkpoint(*ExperimentSaver.load_checkpoint(tts_ckpt),
                                                 ckpt_path=tts_ckpt, device="cpu")
    voc = VocoderEvaluationInterface.from_checkpoint(*ExperimentSaver.load_checkpoint(
        ExperimentSaver.get_last_checkpoint(experiments["vocoder"])), device="cpu")
    return tts, voc


def test_pack_and_load_round_trip(bundle, experiments, tmp_path):
    """The manifest names each component's step directory; the archive holds each
    file once; a bundle extracted once is reused, and a directory loads too."""
    comps = bundle.manifest["components"]
    assert bundle.manifest["format"] == export.FORMAT
    assert comps == {k: f"{k}/step_000000002" for k in ("tts", "vocoder", "xtts")}
    for kind, rel in comps.items():
        src = ExperimentSaver.get_last_checkpoint(experiments[kind])
        for f in ("model.npz", "payload.pkl"):
            assert (bundle.root / rel / f).read_bytes() == (src / f).read_bytes()
    archive = bundle.root.parent / "b.sftpu.tar.gz"
    with tarfile.open(archive) as tf:
        names = tf.getnames()
    assert len(names) == len(set(names)) and "manifest.json" in names
    again = export.InferenceBundle.load(archive, device="cpu")
    assert again.root == bundle.root
    assert export.InferenceBundle.load(bundle.root, device="cpu").manifest == bundle.manifest
    # a step directory and the CLI
    out = tmp_path / "cli.tar.gz"
    step = ExperimentSaver.get_last_checkpoint(experiments["vocoder"])
    assert export.main(["--vocoder", str(step), "-o", str(out)]) == str(out)
    assert export.InferenceBundle.load(out).manifest["components"] == {
        "vocoder": "vocoder/step_000000002"}


def test_missing_and_refused_components(bundle, experiments, tmp_path):
    out = tmp_path / "voc.tar.gz"
    export.pack(out, vocoder=experiments["vocoder"])
    voc_only = export.InferenceBundle.load(out, device="cpu")
    with pytest.raises(KeyError, match="no 'tts' component"):
        voc_only.tts
    with pytest.raises(ValueError, match="nothing to pack"):
        export.pack(tmp_path / "none.tar.gz")
    with pytest.raises(FileNotFoundError, match="no step_"):
        export.pack(tmp_path / "x.tar.gz", tts=tmp_path)
    # a prosody component reaches the TTS interface: a prosody checkpoint serves, the
    # checkpoint of another model in its place is refused
    torch.manual_seed(0)
    pp = ProsodyParams.create(dict(vocab_size=100, dim=16, n_layers=1, n_heads=2))
    prosody = _save(tmp_path, "prosody", ProsodyModel(pp), {"model_params": dataclasses.asdict(pp)})
    out = tmp_path / "prosody.tar.gz"
    export.pack(out, tts=experiments["tts"], prosody=prosody)
    served = export.InferenceBundle.load(out, device="cpu").tts.prosody_interface
    assert served.predict(["hello", "world"])["category"].shape == (2,)
    out = tmp_path / "wrong_prosody.tar.gz"
    export.pack(out, tts=experiments["tts"], prosody=experiments["vocoder"])
    with pytest.raises(KeyError):
        export.InferenceBundle.load(out, device="cpu").tts
    # an orbax checkpoint of the JAX trainer packs and serves as the port's does
    from speechflow_tpu.training.saver import ExperimentSaver as JSaver

    tree, payload = ExperimentSaver.load_checkpoint(
        ExperimentSaver.get_last_checkpoint(experiments["tts"]))
    js = JSaver(tmp_path / "jax", expr_suffix="tts")
    js.save(2, tree["model"], extra=payload)
    root = tmp_path / "orbax"
    export.pack(root.with_suffix(".tar.gz"), tts=js.expr_path, vocoder=experiments["vocoder"])
    jax_bundle = export.InferenceBundle.load(root.with_suffix(".tar.gz"), device="cpu")
    port_bundle = export.InferenceBundle.load(bundle.root, device="cpu")
    assert (jax_bundle.root / jax_bundle.manifest["components"]["tts"] / "_METADATA").is_file()
    jax_bundle.tts, port_bundle.tts, jax_bundle.vocoder, port_bundle.vocoder
    outs = []
    for b in (jax_bundle, port_bundle):
        torch.manual_seed(5)
        outs.append(b.synthesize(TEXT, opts=OPTS).data)
    np.testing.assert_array_equal(outs[0], outs[1])
    # a step directory of neither layout is refused, naming both
    root = tmp_path / "neither"
    (root / "tts" / "step_000000001" / "default").mkdir(parents=True)
    (root / "manifest.json").write_text(json.dumps(
        {"format": export.FORMAT, "components": {"tts": "tts/step_000000001"}}))
    with pytest.raises(FileNotFoundError, match="neither model.npz"):
        export.InferenceBundle.load(root, device="cpu").tts
    (root / "manifest.json").write_text(json.dumps({"format": "other", "components": {}}))
    with pytest.raises(ValueError, match="not a speechflow bundle"):
        export.InferenceBundle.load(root, device="cpu")


def test_bundle_runs_on_the_gpu_unless_asked(bundle, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.InferenceBundle.load(bundle.root).vocoder


def test_bundle_synthesize_is_the_tts_vocoder_chain(bundle, experiments):
    """The first speaker, each sentence's valid frames in order, one vocoder call."""
    tts, voc = _interfaces(experiments)
    bundle.tts, bundle.vocoder  # built before the seed: building draws from the global RNG
    torch.manual_seed(3)
    got = bundle.synthesize(TEXT, opts=OPTS)
    torch.manual_seed(3)
    out = tts.synthesize(TEXT, speaker="amy", opts=OPTS)
    lens = out.spectrogram_lengths.tolist()
    assert len(lens) == 2 and min(lens) > 2
    want = voc.synthesize(torch.cat([out.after_postnet_spectrogram[j, :n]
                                     for j, n in enumerate(lens)]))
    assert got.sr == want.sr and got.data.shape == want.data.shape
    np.testing.assert_array_equal(got.data, want.data)
    assert np.isfinite(got.data).all() and got.data.std() > 0


def test_bundle_xtts(bundle, experiments):
    ref = XTTSEvaluationInterface(ExperimentSaver.get_last_checkpoint(experiments["xtts"]),
                                  device="cpu")
    kw = dict(speaker="bob", max_tokens=8, temperature=0.8, seed=5)
    got = bundle.xtts.synthesize(TEXT, **kw)
    assert got.sr == 24000 and got.data.shape == (8 * 256,)
    np.testing.assert_array_equal(got.data, ref.synthesize(TEXT, **kw).data)


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, b""


def test_demo_server_answers(experiments):
    """On a free port in a thread: the page, the catalog, a WAV as long as the
    chain's sentence by sentence, and 404."""
    tts, voc = _interfaces(experiments)
    srv = make_server(tts, voc, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, ctype, body = _get(base + "/")
        assert code == 200 and ctype == "text/html" and b"<option>bob</option>" in body
        code, ctype, body = _get(base + "/info")
        assert code == 200 and json.loads(body) == {"languages": ["EN", "RU"],
                                                    "speakers": ["amy", "bob", "cyd"]}
        code, ctype, body = _get(base + "/synthesize?text=Hello+world.+Bye!&speaker=cyd")
        assert code == 200 and ctype == "audio/wav"
        out = tts.synthesize("Hello world. Bye!", speaker="cyd", opts=TTSOptions(t_out=T_OUT))
        length = sum(len(voc.synthesize(out.after_postnet_spectrogram[i, :m]).data)
                     for i, m in enumerate(out.spectrogram_lengths.tolist()))
        with wave.open(io.BytesIO(body)) as w:
            assert (w.getframerate(), w.getnchannels(), w.getsampwidth()) == (
                voc.sample_rate, 1, 2)
            assert w.getnframes() == length > 0
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        assert pcm.std() > 0
        assert _get(base + "/nothing")[0] == 404
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
