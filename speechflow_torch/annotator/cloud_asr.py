"""Long-audio transcription through a cloud speech-to-text service
(counterpart of ``speechflow_tpu/annotator/cloud_asr.py``). Host code.

A service (``YandexSTTService``: SpeechKit v2 ``longRunningRecognize``;
``GoogleSTTService``: Cloud Speech v1 ``longrunningrecognize``) only builds the
requests of a recognition's life (upload the 16-bit PCM, submit, poll) and reads
their answers; a ``transport(method, url, headers, payload) -> dict`` sends
them (``http_transport`` over ``urllib``; tests pass a fake). ``CloudASR``
drives one file: resample to the service's rate, upload, submit (a request
limit sleeps ``limit_sleep_s`` and retries, up to ``max_limit_retries``), poll
every ``poll_interval_s`` (a limit while polling sleeps too), and with
``process_file`` write ``<audio>.json`` (the words with their times, the
service, its locale and the date), the ``.txt`` if there is none, and the
annotator's ``.whisper``. ``sleep_func`` is injectable, so tests do not wait.
With ``raise_on_asr_limit_exc`` a limit raises ``ASRRequestLimitException``
instead.
"""

from __future__ import annotations

import json
import logging
import time
import typing as tp
from dataclasses import dataclass, field
from datetime import datetime, timezone
from pathlib import Path

import numpy as np

from speechflow_torch.annotator.asr import ASRBase
from speechflow_torch.io.audio import AudioChunk

__all__ = ["ASRException", "ASRRequestLimitException", "STTService", "YandexSTTService",
           "GoogleSTTService", "CloudASR", "http_transport", "run_cloud_transcription"]

LOGGER = logging.getLogger("speechflow_torch")

#: transport(method, url, headers, payload) -> the answer's JSON; the payload is a
#: JSON-serialisable dict, raw bytes (an upload) or None
Transport = tp.Callable[[str, str, tp.Mapping[str, str], tp.Any], dict]


class ASRException(Exception):
    """The service failed for good."""


class ASRRequestLimitException(ASRException):
    """The service's request or quota limit."""


def http_transport(method: str, url: str, headers: tp.Mapping[str, str], payload: tp.Any,
                   timeout: float = 60.0) -> dict:
    """One HTTP request with ``urllib``: a dict payload as JSON, bytes as they are;
    the answer read as JSON."""
    import urllib.request

    raw = isinstance(payload, (bytes, bytearray))
    data = payload if raw else (json.dumps(payload).encode() if payload is not None else None)
    req = urllib.request.Request(url, data=data, method=method, headers=dict(headers))
    if data is not None and not raw:
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=timeout) as resp:  # noqa: S310
        return json.loads(resp.read().decode("utf-8"))


def _words(alternatives: tp.Iterable[dict]) -> dict:
    """The words of each result's first alternative: ``{"done": True, "text",
    "timestamps"}`` (times given as ``"1.23s"`` strings or numbers)."""
    stamps = [[w["word"], float(str(w["startTime"]).rstrip("s")),
               float(str(w["endTime"]).rstrip("s"))]
              for alt in alternatives for w in alt.get("words", [])]
    return {"done": True, "text": " ".join(s[0] for s in stamps), "timestamps": stamps}


def _error_message(err: tp.Any) -> str:
    return err.get("message", str(err)) if isinstance(err, dict) else str(err)


@dataclass
class STTService:
    """A service's dialect; ``credentials`` as a user's YAML or JSON file holds them."""

    credentials: tp.Mapping[str, tp.Any]
    locale_code: str = "en-US"
    sample_rate: int = 16000

    def submit(self, transport: Transport, audio_pcm16: bytes, audio_name: str) -> str:
        """Upload and start the recognition; returns the operation's id."""
        raise NotImplementedError

    def poll(self, transport: Transport, op_id: str) -> dict:
        """One poll: ``{"done": False}``, ``{"done": False, "limit": msg}``, ``{"done":
        True, "error": msg}`` or ``{"done": True, "text", "timestamps"}``."""
        raise NotImplementedError

    @classmethod
    def from_credentials_file(cls, path: tp.Union[str, Path], **kwargs) -> "STTService":
        from speechflow_torch.io.config import yaml_load

        path = Path(path)
        text = path.read_text(encoding="utf-8")
        creds = yaml_load(text) if path.suffix in (".yml", ".yaml") else json.loads(text)
        return cls(credentials=creds, **kwargs)

    def _upload(self, transport: Transport, audio_pcm16: bytes, audio_name: str) -> str:
        """PUT the audio under the upload URL; returns the URI the service reads."""
        url = f"{self.upload_url or self.credentials.get('upload_url', '')}/{audio_name}"
        return transport("PUT", url, self._headers(), audio_pcm16).get("uri", url)

    def _headers(self) -> dict:
        raise NotImplementedError


@dataclass
class YandexSTTService(STTService):
    endpoint: str = "https://transcribe.api.cloud.yandex.net/speech/stt/v2"
    operations: str = "https://operation.api.cloud.yandex.net/operations"
    upload_url: str = ""  # object storage, or any presigned PUT endpoint

    def _headers(self) -> dict:
        return {"Authorization": f"Api-Key {self.credentials['api_key']}"}

    def submit(self, transport: Transport, audio_pcm16: bytes, audio_name: str) -> str:
        body = {
            "config": {"specification": {
                "languageCode": self.locale_code,
                # raw 16-bit PCM: SpeechKit reads Ogg/Opus unless told otherwise
                "audioEncoding": "LINEAR16_PCM",
                "sampleRateHertz": self.sample_rate,
                "rawResults": True,
            }},
            "audio": {"uri": self._upload(transport, audio_pcm16, audio_name)},
        }
        resp = transport("POST", f"{self.endpoint}/longRunningRecognize", self._headers(), body)
        if "id" not in resp:
            msg = resp.get("message", str(resp))
            raise (ASRRequestLimitException if "limit" in msg.lower() else ASRException)(msg)
        return str(resp["id"])

    def poll(self, transport: Transport, op_id: str) -> dict:
        resp = transport("GET", f"{self.operations}/{op_id}", self._headers(), None)
        msg = resp.get("message", "")
        if "limit" in msg.lower():
            return {"done": False, "limit": msg}
        if resp.get("code") == 13 or "error" in resp:
            return {"done": True, "error": resp.get("error", msg)}
        if not resp.get("done"):
            return {"done": False}
        chunks = resp.get("response", {}).get("chunks")
        if not chunks:
            return {"done": True, "error": "Speech in the audio file is not recognized!"}
        return _words(c["alternatives"][0] for c in chunks)


@dataclass
class GoogleSTTService(STTService):
    endpoint: str = "https://speech.googleapis.com/v1"
    upload_url: str = ""

    def _headers(self) -> dict:
        return {"Authorization": f"Bearer {self.credentials['token']}"}

    def submit(self, transport: Transport, audio_pcm16: bytes, audio_name: str) -> str:
        body = {
            "config": {"encoding": "LINEAR16", "sampleRateHertz": self.sample_rate,
                       "languageCode": self.locale_code, "enableWordTimeOffsets": True},
            "audio": {"uri": self._upload(transport, audio_pcm16, audio_name)},
        }
        resp = transport("POST", f"{self.endpoint}/speech:longrunningrecognize",
                         self._headers(), body)
        if "name" not in resp:
            msg = _error_message(resp.get("error", str(resp)))
            limit = "quota" in msg.lower() or "limit" in msg.lower()
            raise (ASRRequestLimitException if limit else ASRException)(msg)
        return str(resp["name"])

    def poll(self, transport: Transport, op_id: str) -> dict:
        resp = transport("GET", f"{self.endpoint}/operations/{op_id}", self._headers(), None)
        if resp.get("error"):
            msg = _error_message(resp["error"])
            if "quota" in msg.lower() or "limit" in msg.lower():
                return {"done": False, "limit": msg}
            return {"done": True, "error": msg}
        if not resp.get("done"):
            return {"done": False}
        results = resp.get("response", {}).get("results")
        if not results:
            return {"done": True, "error": "Speech in the audio file is not recognized!"}
        return _words(r["alternatives"][0] for r in results)


@dataclass
class CloudASR(ASRBase):
    service: STTService
    transport: Transport = http_transport
    raise_on_asr_limit_exc: bool = False
    poll_interval_s: float = 5.0
    limit_sleep_s: float = 600.0
    max_limit_retries: int = 4
    max_polls: int = 720
    sleep_func: tp.Callable[[float], None] = time.sleep
    output_file_ext: str = ".json"
    write_whisper: bool = True
    _counter: int = field(default=0, repr=False)

    def transcribe(self, audio: AudioChunk) -> dict:
        sr = self.service.sample_rate
        wav = AudioChunk(data=audio.waveform, sr=audio.sr).resample(sr).waveform
        pcm16 = (np.clip(np.asarray(wav, np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
        self._counter += 1
        name = f"{Path(audio.file_path or 'audio').stem}_{self._counter}.pcm"
        op_id = self._submit_with_backoff(pcm16.tobytes(), name)
        for _ in range(self.max_polls):
            status = self.service.poll(self.transport, op_id)
            if "limit" in status:
                self._limit(status["limit"])
                continue
            if status.get("done"):
                if "error" in status:
                    raise ASRException(status["error"])
                return {"text": status["text"], "timestamps": status["timestamps"]}
            self.sleep_func(self.poll_interval_s)
        raise ASRException(f"operation {op_id} did not finish within {self.max_polls} polls")

    def _limit(self, msg: str) -> None:
        if self.raise_on_asr_limit_exc:
            raise ASRRequestLimitException(msg)
        LOGGER.warning("%s - sleep...", msg)
        self.sleep_func(self.limit_sleep_s)

    def _submit_with_backoff(self, pcm16: bytes, name: str) -> str:
        for _ in range(self.max_limit_retries + 1):
            try:
                return self.service.submit(self.transport, pcm16, name)
            except ASRRequestLimitException as e:
                self._limit(str(e))
        raise ASRException(f"request limit persisted across {self.max_limit_retries} retries")

    def process_file(self, path: tp.Union[str, Path], overwrite: bool = False) -> dict:
        """The file's transcript, from its ``output_file_ext`` file if there is one
        (unless ``overwrite``), else from the service, written as above."""
        path = Path(path)
        out_path = path.with_suffix(self.output_file_ext)
        if out_path.exists() and not overwrite:
            return json.loads(out_path.read_text(encoding="utf-8"))
        result = self(path)
        result.update({"api": type(self.service).__name__,
                       "locale_code": self.service.locale_code,
                       "date": datetime.now(timezone.utc).strftime("%d/%m/%Y %H:%M:%S")})
        out_path.write_text(json.dumps(result, ensure_ascii=False, indent=4), encoding="utf-8")
        txt = path.with_suffix(".txt")
        if not txt.exists():
            txt.write_text(result["text"], encoding="utf-8")
        if self.write_whisper:
            path.with_suffix(".whisper").write_text(
                json.dumps({"text": result["text"], "timestamps": result["timestamps"]},
                           ensure_ascii=False, indent=2), encoding="utf-8")
        return result

    @classmethod
    def json_to_txt(cls, json_path: tp.Union[str, Path], gap_s: float = 1.0) -> Path:
        """The transcript ``.json`` as a ``.txt`` timeline: a line ``h:mm:ss:h:mm:ss<TAB>
        words`` for each run of words without a silence over ``gap_s`` (the text
        alone when there are no timestamps)."""
        json_path = Path(json_path)
        data = json.loads(json_path.read_text(encoding="utf-8"))
        stamps = data.get("timestamps") or []

        def hms(sec: float) -> str:
            sec = int(sec)
            return f"{sec // 3600}:{(sec % 3600) // 60:02d}:{sec % 60:02d}"

        lines = []
        if stamps:
            segments: tp.List[list] = [[stamps[0]]]
            for prev, cur in zip(stamps, stamps[1:]):
                if float(cur[1]) - float(prev[2]) > gap_s:
                    segments.append([])
                segments[-1].append(cur)
            lines = [f"{hms(float(s[0][1]))}:{hms(float(s[-1][2]))}\t"
                     + " ".join(str(w[0]) for w in s) + "\n" for s in segments]
        out = json_path.with_suffix(".txt")
        out.write_text("".join(lines) or data.get("text", ""), encoding="utf-8")
        return out


def run_cloud_transcription(data_root: tp.Union[str, Path], asr: CloudASR, ext: str = ".wav",
                            overwrite: bool = False) -> int:
    """``asr.process_file`` over every ``ext`` file under ``data_root``; returns the
    number done. A request limit raises; another service error is logged and the
    sweep goes on."""
    from speechflow_torch.io.flist import construct_file_list

    done = 0
    for f in construct_file_list(data_root, ext=ext):
        try:
            asr.process_file(f, overwrite=overwrite)
            done += 1
        except ASRRequestLimitException:
            raise
        except ASRException as e:
            LOGGER.error("%s: %s", f, e)
    return done
