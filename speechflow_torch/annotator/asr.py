"""Transcription for dataset annotation (counterpart of
``speechflow_tpu/annotator/asr.py``): the ``.whisper`` transcript format
(``{"text": ..., "timestamps": [[token, begin_s, end_s], ...]}``), the
``ASRBase`` interface, ``FileASR`` (reads the ``.whisper`` file beside an audio
file), ``CTCPhonemeASR`` (the trainable CTC phoneme recognizer of
``models/asr``) and ``run_audio_transcription`` (the annotator's step 0: a
``.whisper`` file beside every audio file).

``WhisperASR`` needs the ``transformers`` package and Whisper's weights, which
the port does not carry: it raises when built, naming the package, and never
falls back on another recognizer.
"""

from __future__ import annotations

import json
import typing as tp
from pathlib import Path

import numpy as np
import torch

from speechflow_torch.io.audio import AudioChunk

__all__ = ["ASRBase", "FileASR", "WhisperASR", "CTCPhonemeASR", "convert_media_to_opus",
           "run_audio_transcription"]


class ASRBase:
    def transcribe(self, audio: AudioChunk) -> dict:
        """-> {"text": str, "timestamps": [[token, begin_s, end_s], ...]}"""
        raise NotImplementedError

    def __call__(self, path: tp.Union[str, Path]) -> dict:
        return self.transcribe(AudioChunk(file_path=path).load())


class FileASR(ASRBase):
    """Reads the ``.whisper`` file beside an audio file."""

    def __call__(self, path: tp.Union[str, Path]) -> dict:
        return json.loads(Path(path).with_suffix(".whisper").read_text(encoding="utf-8"))

    def transcribe(self, audio: AudioChunk) -> dict:
        return self(audio.file_path)


class WhisperASR(ASRBase):
    """HF Whisper: not ported, since it needs ``transformers`` and its weights."""

    def __init__(self, model_name: str = "openai/whisper-small", device: str = "cpu"):
        raise NotImplementedError(
            f"WhisperASR ({model_name}) needs the transformers package and the model's "
            "weights, which the port does not carry: give precomputed .whisper files "
            "(FileASR) or a CTC checkpoint (CTCPhonemeASR)")


def convert_media_to_opus(data_root: tp.Union[str, Path], ext: str = ".wav",
                          sr: tp.Optional[int] = None, overwrite: bool = False) -> tp.List[Path]:
    """Every ``ext`` file under ``data_root`` re-encoded as Ogg/Opus beside it (at
    ``sr`` where given; one already there is kept unless ``overwrite``): the written
    paths, as JAX's. Needs the Opus libraries (``io.codecs``)."""
    from speechflow_torch.io.flist import construct_file_list

    out = []
    for f in construct_file_list(data_root, ext=ext):
        dst = Path(f).with_suffix(".opus")
        if overwrite or not dst.exists():
            AudioChunk(file_path=f).load(sr=sr).save(dst, overwrite=True)
        out.append(dst)
    return out


def run_audio_transcription(data_root: tp.Union[str, Path], asr: tp.Optional[ASRBase] = None,
                            ext: str = ".wav", n_processes: int = 0,
                            overwrite: bool = False) -> int:
    """Write ``asr``'s transcript (default ``WhisperASR``) as the ``.whisper`` file
    beside every ``ext`` file under ``data_root`` that has none (every one with
    ``overwrite``); returns the number of files with a transcript. The files go
    one after another through the one recognizer, whatever ``n_processes``
    asks (JAX's keyword, which its loop does not use either)."""
    from speechflow_torch.io.flist import construct_file_list

    asr = asr or WhisperASR()
    done = 0
    for f in construct_file_list(data_root, ext=ext):
        side = Path(f).with_suffix(".whisper")
        if overwrite or not side.exists():
            side.write_text(json.dumps(asr(f), ensure_ascii=False, indent=2), encoding="utf-8")
        done += 1
    return done


class CTCPhonemeASR(ASRBase):
    """The CTC recognizer of ``model_ckpt`` (a ``save_module`` pickle of a
    ``CTCRecognizer``, either package's) behind the ASR interface, on
    ``device`` (the GPU unless ``device="cpu"``): phoneme tokens
    (``id_to_symbol`` maps label ids to symbols, else their decimal strings)
    with frame timestamps. Audio longer than ``chunk_s`` is decoded in windows
    of ``chunk_s`` (the last zero-padded) every ``chunk_s - 2·overlap_s``
    seconds; a token belongs to the window whose core (the window less
    ``overlap_s`` on each side that has a neighbour) holds its centre."""

    chunk_s: float = 20.0
    overlap_s: float = 0.5

    def __init__(self, model_ckpt: tp.Union[str, Path],
                 id_to_symbol: tp.Optional[tp.Mapping[int, str]] = None,
                 device: tp.Union[str, torch.device, None] = None):
        from speechflow_torch.models.asr import CTCRecognizer, CTCRecognizerParams
        from speechflow_torch.utils.state_io import load_module

        self.model, self.params = load_module(CTCRecognizer, CTCRecognizerParams, model_ckpt,
                                              device=device)
        self.id_to_symbol = dict(id_to_symbol or {})

    def _decode_window(self, wav: np.ndarray, sr: int) -> tp.List[tp.Tuple[str, float, float]]:
        from speechflow_torch.models.asr import greedy_ctc_decode

        x = torch.from_numpy(np.ascontiguousarray(wav[None], np.float32)).to(
            next(self.model.parameters()).device)
        with torch.inference_mode():
            logits = self.model.recognize(x)[0]
        hop_s = self.params.hop_length * self.params.time_stride / sr
        ids, spans = greedy_ctc_decode(logits, hop_s=hop_s)
        tokens = [self.id_to_symbol.get(int(i), str(int(i))) for i in ids]
        return [(tok, float(b), float(e)) for tok, (b, e) in zip(tokens, spans)]

    def transcribe(self, audio: AudioChunk) -> dict:
        sr = self.params.sample_rate
        chunk = audio if audio.sr == sr else audio.resample(sr)
        wav = np.asarray(chunk.waveform, np.float32)
        win = int(self.chunk_s * sr)
        if len(wav) <= win:
            stamps = self._decode_window(wav, sr)
        else:
            ov = int(self.overlap_s * sr)
            step = win - 2 * ov
            stamps, start = [], 0
            while start < len(wav):
                piece = wav[start: start + win]
                if len(piece) < win:  # zero-pad the tail to the shared shape
                    piece = np.pad(piece, (0, win - len(piece)))
                core_lo = 0.0 if start == 0 else self.overlap_s
                core_hi = (self.chunk_s - self.overlap_s if start + win < len(wav)
                           else self.chunk_s)
                ofs = start / sr
                for tok, b, e in self._decode_window(piece, sr):
                    if core_lo <= 0.5 * (b + e) < core_hi:  # this window owns the token
                        stamps.append((tok, ofs + b, ofs + e))
                start += step
        return {"text": " ".join(t for t, _, _ in stamps),
                "timestamps": [[tok, b, e] for tok, b, e in stamps]}
