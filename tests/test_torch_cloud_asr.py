"""The cloud ASR client (``speechflow_torch/annotator/cloud_asr.py``) against the
JAX package's, through the scenarios of ``tests/test_cloud_asr.py`` with the same
scripted fake services (no network): each package gets a fresh copy of the
scenario and the same wav, and must send the same requests (method, URL,
headers, body; the uploaded PCM bytes too), sleep the same, end the same way
(a result or the same exception) and write the same sidecars (``.json`` but
its date, ``.txt``, ``.whisper``). Also ``json_to_txt``, the Google dialect
and the sweep over a directory."""

import copy
import json
import shutil

import numpy as np
import pytest
import torch

from speechflow_torch.annotator import cloud_asr as PC
from speechflow_torch.io.audio import AudioChunk

torch.set_num_threads(1)
WORDS = [["hello", 0.1, 0.4], ["world", 0.5, 0.9]]


def _words() -> list:
    return [{"word": w, "startTime": f"{b}s", "endTime": f"{e}s"} for w, b, e in WORDS]


def yandex_done():
    return {"done": True, "response": {"chunks": [{"alternatives": [{
        "text": "hello world", "words": _words()}]}]}}


def google_done():
    return {"done": True, "response": {"results": [{"alternatives": [{
        "words": _words()}]}]}}


class FakeCloud:
    """A scripted service: PUT uploads, POST submits (``submit_script``: the answers
    in order, the last repeating), GET polls (``poll_script`` likewise); every call
    recorded whole."""

    def __init__(self, submit_script, poll_script):
        self.submit_script, self.poll_script = list(submit_script), list(poll_script)
        self.calls, self.sleeps = [], []

    def __call__(self, method, url, headers, payload):
        self.calls.append((method, url, dict(headers),
                           bytes(payload) if isinstance(payload, (bytes, bytearray))
                           else copy.deepcopy(payload)))
        if method == "PUT":
            return {"uri": url}
        script = self.submit_script if method == "POST" else self.poll_script
        return copy.deepcopy(script.pop(0) if len(script) > 1 else script[0])

    def sleep(self, seconds):
        self.sleeps.append(seconds)


SCENARIOS = {
    "happy_path": ("yandex", [{"id": "op-42"}], [{"done": False}, yandex_done()], {}),
    "limit_backoff": ("yandex", [{"message": "active operation limit exceeded"},
                                 {"id": "op-42"}],
                      [{"done": False, "message": "limit exceeded"}, yandex_done()], {}),
    "limit_raises": ("yandex", [{"message": "active operation limit exceeded"}],
                     [yandex_done()], {"raise_on_asr_limit_exc": True}),
    "limit_persists": ("yandex", [{"message": "active operation limit exceeded"}],
                       [yandex_done()], {"max_limit_retries": 2}),
    "unrecognized": ("yandex", [{"id": "op-42"}], [{"done": True, "response": {}}], {}),
    "service_error": ("yandex", [{"id": "op-42"}], [{"code": 13, "message": "internal"}], {}),
    "never_done": ("yandex", [{"id": "op-42"}], [{"done": False}], {"max_polls": 3}),
    "google": ("google", [{"name": "ops/7"}], [{"done": False}, google_done()], {}),
    "google_quota": ("google", [{"error": {"message": "Quota exceeded"}}, {"name": "ops/7"}],
                     [{"error": {"message": "rate limit"}}, google_done()], {}),
}


def _wav(dir_):
    sr = 8000
    t = np.arange(sr) / sr
    path = dir_ / "utt.wav"
    dir_.mkdir(parents=True, exist_ok=True)
    AudioChunk(data=(0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), sr=sr).save(path)
    return path


def _asr(mod, dialect, cloud, **kwargs):
    cls = mod.YandexSTTService if dialect == "yandex" else mod.GoogleSTTService
    service = cls(credentials={"api_key": "k", "token": "t", "upload_url": "mem://bucket"},
                  locale_code="en-US")
    return mod.CloudASR(service=service, transport=cloud, sleep_func=cloud.sleep, **kwargs)


def _sidecars(wav):
    out = {}
    for ext in (".json", ".txt", ".whisper"):
        p = wav.with_suffix(ext)
        if p.exists():
            text = p.read_text(encoding="utf-8")
            out[ext] = {k: v for k, v in json.loads(text).items() if k != "date"} \
                if ext == ".json" else text
    return out


def _run(mod, tmp, name):
    dialect, submits, polls, kwargs = SCENARIOS[name]
    wav = _wav(tmp)
    cloud = FakeCloud(submits, polls)
    try:
        result = _asr(mod, dialect, cloud, **kwargs).process_file(wav)
        result = {k: v for k, v in result.items() if k != "date"}
    except Exception as e:  # noqa: BLE001  (the two packages must raise alike)
        result = (type(e).__name__, str(e))
    return cloud.calls, cloud.sleeps, result, _sidecars(wav)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_cloud_asr_scenarios_match_jax(name, tmp_path):
    from speechflow_tpu.annotator import cloud_asr as JC

    ours = _run(PC, tmp_path / "port", name)
    ref = _run(JC, tmp_path / "jax", name)
    calls, sleeps, result, files = ours
    assert len(calls) == len(ref[0])
    for a, b in zip(calls, ref[0]):
        assert a[:3] == b[:3] and type(a[3]) is type(b[3]) and a[3] == b[3], (a[:3], b[:3])
    assert sleeps == ref[1] and result == ref[2] and files == ref[3]
    if name == "happy_path":
        assert result["timestamps"] == WORDS and files[".whisper"] and sleeps == [5.0]
        assert calls[0][0] == "PUT" and len(calls[0][3]) == 2 * 16000
    if name in ("limit_raises", "limit_persists", "unrecognized", "never_done"):
        assert isinstance(result, tuple) and not files


def test_existing_sidecar_is_read_not_requested(tmp_path):
    wav = _wav(tmp_path)
    wav.with_suffix(".json").write_text(json.dumps({"text": "cached", "timestamps": []}))
    cloud = FakeCloud([{"id": "x"}], [yandex_done()])
    out = _asr(PC, "yandex", cloud).process_file(wav)
    assert out["text"] == "cached" and cloud.calls == []


@pytest.mark.parametrize("stamps", [
    [["hello", 61.0, 61.5], ["world", 62.0, 62.8]],
    [["a", 0.0, 0.4], ["b", 0.5, 0.9], ["c", 3.0, 3.5], ["d", 3600.2, 3601.0]],
    [],
])
def test_json_to_txt_matches_jax(stamps, tmp_path):
    from speechflow_tpu.annotator.cloud_asr import CloudASR as JCloud

    texts = []
    for cls, sub in ((PC.CloudASR, "port"), (JCloud, "jax")):
        j = tmp_path / sub / "utt.json"
        j.parent.mkdir()
        j.write_text(json.dumps({"text": "hello world", "timestamps": stamps}))
        texts.append(cls.json_to_txt(j).read_text())
    assert texts[0] == texts[1]
    if len(stamps) == 2:
        assert texts[0] == "0:01:01:0:01:02\thello world\n"


def test_run_cloud_transcription_matches_jax(tmp_path):
    """A sweep over two wavs: the same count and sidecars; a service error is
    logged and skipped, a request limit raises."""
    from speechflow_tpu.annotator import cloud_asr as JC

    out = []
    for mod, sub in ((PC, "port"), (JC, "jax")):
        wav = _wav(tmp_path / sub)
        shutil.copy(wav, wav.with_name("utt2.wav"))
        cloud = FakeCloud([{"id": "op-42"}], [yandex_done()])
        n = mod.run_cloud_transcription(wav.parent, _asr(mod, "yandex", cloud))
        out.append((n, _sidecars(wav), _sidecars(wav.with_name("utt2.wav")), len(cloud.calls)))
        bad = FakeCloud([{"id": "op-42"}], [{"done": True, "response": {}}])
        assert mod.run_cloud_transcription(wav.parent, _asr(mod, "yandex", bad),
                                           overwrite=True) == 0
        limited = FakeCloud([{"message": "limit"}], [yandex_done()])
        with pytest.raises(mod.ASRRequestLimitException):
            mod.run_cloud_transcription(wav.parent, _asr(mod, "yandex", limited,
                                                         raise_on_asr_limit_exc=True),
                                        overwrite=True)
    assert out[0] == out[1] and out[0][0] == 2


def test_credentials_files_read_as_jax(tmp_path):
    """``from_credentials_file``: a YAML file (read by the port's own reader, by PyYAML
    in JAX) and a JSON file give the same service."""
    from speechflow_tpu.annotator import cloud_asr as JC

    (tmp_path / "c.yml").write_text("api_key: 'k-1'\nupload_url: https://u.example/b\n"
                                    "folder_id: 42\n")
    (tmp_path / "c.json").write_text(json.dumps({"token": "t-2", "upload_url": "mem://x"}))
    for name, cls in (("c.yml", "YandexSTTService"), ("c.json", "GoogleSTTService")):
        ours = getattr(PC, cls).from_credentials_file(tmp_path / name, locale_code="ru-RU")
        ref = getattr(JC, cls).from_credentials_file(tmp_path / name, locale_code="ru-RU")
        assert dict(ours.credentials) == dict(ref.credentials) and ours._headers() == \
            ref._headers() and ours.locale_code == "ru-RU"
