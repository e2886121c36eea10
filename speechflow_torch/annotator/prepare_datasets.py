"""Public TTS corpora into the annotator's layout, an ``<utterance>.wav`` with its
``<utterance>.txt`` (counterpart of ``speechflow_tpu/annotator/prepare_datasets.py``).
Host code; each preparer restructures a tree already downloaded:

- ``ljspeech``: ``metadata.csv`` (``id|text|normalized text``) -> ``wavs/<id>.txt``
  beside each wav there is;
- ``libri_tts``: ``*.normalized.txt`` -> ``*.txt``, then Ogg audio to wav;
- ``hifi_tts``: the JSON-lines manifests (``audio_filepath``, ``text_normalized``)
  -> a ``.txt`` beside each audio file there is, then Ogg audio to wav;
- ``golos``: each folder's ``manifest.jsonl`` (``audio_filepath``, ``text``) -> the
  ``.txt``, the wav scaled to ``target_dbfs`` (RMS), and ``all_meta.txt`` (``path|text``
  a line).

Ogg/Vorbis and Ogg/Opus decode through ``io/codecs.py``; FLAC has no decoder here
and raises. The conversions and golos' files go through ``EasyDSParser`` in
``n_processes`` processes.

    python -m speechflow_torch.annotator.prepare_datasets ljspeech -d <root>
    python -m speechflow_torch.annotator.prepare_datasets golos -d <root> -nproc 8
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import typing as tp
from pathlib import Path

import numpy as np

from speechflow_torch.data.parsers import EasyDSParser
from speechflow_torch.io.audio import AudioChunk, AudioFormat

__all__ = ["prepare_ljspeech", "prepare_libri_tts", "prepare_hifi_tts", "prepare_golos",
           "convert_to_wav", "main"]

LOGGER = logging.getLogger("speechflow_torch")


def convert_to_wav(path: tp.Union[str, Path], remove_source: bool = True) -> Path:
    """The audio file decoded to the ``.wav`` beside it (the source removed with
    ``remove_source``); a wav is left as it is. FLAC and unknown types raise."""
    path = Path(path)
    if path.suffix.lower() == ".flac":
        raise RuntimeError(
            f"{path}: no FLAC decoder is available in this environment — "
            "decode to wav externally (e.g. `flac -d`) before preparing")
    if not AudioFormat.check(path):
        raise RuntimeError(f"{path}: unsupported audio format")
    wav_path = path.with_suffix(".wav")
    if path.suffix.lower() != ".wav":
        AudioChunk(file_path=path).load().save(wav_path, overwrite=True)
        if remove_source:
            path.unlink()
    return wav_path


def _convert_tree_to_wav(data_root: Path, n_processes: int = 0) -> int:
    """Every ``.ogg``, ``.oga`` and ``.opus`` file under ``data_root`` to wav."""
    todo = [str(p) for ext in (".ogg", ".oga", ".opus") for p in data_root.rglob(f"*{ext}")]
    if not todo:
        return 0
    return len(EasyDSParser(fn=convert_to_wav, n_processes=n_processes).read_datasamples(todo))


def prepare_ljspeech(data_root: tp.Union[str, Path]) -> int:
    data_root = Path(data_root)
    n = 0
    for line in (data_root / "metadata.csv").read_text(encoding="utf-8").splitlines():
        if not line.strip():
            continue
        name, _, text_norm = line.split("|", maxsplit=2)
        wav_path = data_root / "wavs" / f"{name}.wav"
        if wav_path.exists():
            wav_path.with_suffix(".txt").write_text(text_norm, encoding="utf-8")
            n += 1
    return n


def prepare_libri_tts(data_root: tp.Union[str, Path], n_processes: int = 0) -> int:
    data_root = Path(data_root)
    n = 0
    for file in data_root.rglob("*.normalized.txt"):
        Path(str(file).replace(".normalized.txt", ".txt")).write_text(
            file.read_text(encoding="utf-8"), encoding="utf-8")
        n += 1
    _convert_tree_to_wav(data_root, n_processes)
    return n


def prepare_hifi_tts(data_root: tp.Union[str, Path], n_processes: int = 0) -> int:
    data_root = Path(data_root)
    n = 0
    for manifest in data_root.rglob("*.json"):
        for line in manifest.read_text(encoding="utf-8").splitlines():
            if not line.strip():
                continue
            try:
                meta = json.loads(line)
                audio_path = data_root / meta["audio_filepath"]
                if audio_path.exists():
                    audio_path.with_suffix(".txt").write_text(meta["text_normalized"],
                                                              encoding="utf-8")
                    n += 1
            except Exception as e:  # noqa: BLE001  (a bad line is skipped, as in JAX)
                LOGGER.warning("skip manifest line (%s): %s", manifest, e)
    _convert_tree_to_wav(data_root, n_processes)
    return n


def _dbfs(wav: np.ndarray) -> float:
    rms = float(np.sqrt(np.mean(np.square(wav, dtype=np.float64)) + 1e-20))
    return 20.0 * np.log10(max(rms, 1e-10))


def _golos_one(item: str, target_dbfs: float) -> str:
    """``<wav>\\t<text>``: the wav scaled to ``target_dbfs`` in place and its
    ``.txt`` written; returns ``<wav>|<text>``."""
    wav_path, text = item.split("\t", maxsplit=1)
    chunk = AudioChunk(file_path=wav_path).load()
    if chunk.sr < 16000:
        raise ValueError(f"{wav_path}: sample rate {chunk.sr} < 16k")
    chunk.volume(10.0 ** ((target_dbfs - _dbfs(chunk.waveform)) / 20.0))
    chunk.save(wav_path, overwrite=True)
    Path(wav_path).with_suffix(".txt").write_text(text, encoding="utf-8")
    return f"{wav_path}|{text}"


def prepare_golos(data_root: tp.Union[str, Path], target_dbfs: float = -30.0,
                  n_processes: int = 0) -> int:
    data_root = Path(data_root)
    items: tp.List[str] = []
    for manifest in sorted(data_root.rglob("manifest.jsonl")):
        for line in manifest.read_text(encoding="utf-8").splitlines():
            if not line.strip():
                continue
            meta = json.loads(line)
            wav_path = manifest.parent / meta["audio_filepath"]
            if wav_path.exists():
                items.append(f"{wav_path}\t{meta['text']}")
            else:
                LOGGER.warning("golos: missing %s", wav_path)
    parser = EasyDSParser(fn=functools.partial(_golos_one, target_dbfs=target_dbfs),
                          n_processes=n_processes)
    lines = [s.additional["result"] for s in parser.read_datasamples(items)
             if s.additional.get("result")]
    (data_root / "all_meta.txt").write_text("".join(f"{ln}\n" for ln in lines),
                                            encoding="utf-8")
    return len(lines)


_PREPARERS = {"ljspeech": prepare_ljspeech, "libri_tts": prepare_libri_tts,
              "hifi_tts": prepare_hifi_tts, "golos": prepare_golos}


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Prepare a public TTS corpus")
    p.add_argument("corpus", choices=sorted(_PREPARERS))
    p.add_argument("-d", "--data_root", type=Path, required=True)
    p.add_argument("-nproc", "--n_processes", type=int, default=0)
    args = p.parse_args(argv)
    kwargs = {} if args.corpus == "ljspeech" else {"n_processes": args.n_processes}
    n = _PREPARERS[args.corpus](args.data_root, **kwargs)
    print(f"DONE! Prepared {n} files")
    return n


if __name__ == "__main__":
    main()
