"""Utterance segmentation (counterpart of
``speechflow_tpu/annotator/seg_generator.py``): long audio and its text ->
utterance TextGrids with their wavs. Host code.

The text (the ``.txt`` beside the audio, else the ASR's) is aligned to the
ASR's word timestamps (``text_alignment.align_words``), cut into sentences
after words ending in ``.!?;``, and the sentences grouped greedily while an
utterance stays within ``max_duration`` (a sentence that would take it past
starts the next one). Each utterance, padded by ``pad_s`` within the audio and
at least ``min_duration`` long, becomes ``<N>.TextGrid`` (a ``text`` tier of
its words with the silences between them, an ``orig`` tier of its text, and
the meta dict: lang, speaker, the source audio and window, the utterance's
position) and ``<N>.wav`` in the output directory, N counting on from
``start_index``.
"""

from __future__ import annotations

import re
import typing as tp
from pathlib import Path

from speechflow_torch.annotator.asr import ASRBase, FileASR
from speechflow_torch.annotator.text_alignment import align_words, tokenize_text
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.io.flist import construct_file_list
from speechflow_torch.io.seg import AudioSeg, TextGrid, Tier

__all__ = ["SegGenerator"]

_SENT_END = re.compile(r"[.!?;]$")

Word = tp.Tuple[str, float, float]


class SegGenerator:
    def __init__(self, asr: tp.Optional[ASRBase] = None, max_duration: float = 10.0,
                 min_duration: float = 0.5, pad_s: float = 0.1, lang: str = "EN",
                 speaker_name: tp.Optional[str] = None):
        self.asr = asr or FileASR()
        self.max_duration = max_duration
        self.min_duration = min_duration
        self.pad_s = pad_s
        self.lang = lang
        self.speaker_name = speaker_name

    @staticmethod
    def sentences_with_times(words: tp.Sequence[Word]) -> tp.List[tp.List[Word]]:
        out, cur = [], []
        for w in words:
            cur.append(w)
            if _SENT_END.search(w[0]):
                out.append(cur)
                cur = []
        if cur:
            out.append(cur)
        return out

    def group_utterances(self, sentences: tp.Sequence[tp.List[Word]]) -> tp.List[tp.List[Word]]:
        utts, cur = [], []
        for sent in sentences:
            begin = cur[0][1] if cur else sent[0][1]
            if cur and sent[-1][2] - begin > self.max_duration:
                utts.append(cur)
                cur = list(sent)
            else:
                cur.extend(sent)
        if cur:
            utts.append(cur)
        return utts

    def process_file(self, audio_path: tp.Union[str, Path], text: tp.Optional[str] = None,
                     out_dir: tp.Optional[tp.Union[str, Path]] = None,
                     start_index: int = 0) -> tp.List[Path]:
        """The utterances of one audio file, written to ``out_dir`` (default
        ``SEGS`` beside the audio); returns the TextGrid paths."""
        audio_path = Path(audio_path)
        asr_out = self.asr(audio_path)
        if text is None:
            txt = audio_path.with_suffix(".txt")
            text = txt.read_text(encoding="utf-8").strip() if txt.exists() else asr_out["text"]
        total = AudioChunk(file_path=audio_path).duration
        words = align_words(tokenize_text(text), asr_out["timestamps"], total)
        utts = self.group_utterances(self.sentences_with_times(words))

        out_dir = Path(out_dir or audio_path.parent / "SEGS")
        out_dir.mkdir(parents=True, exist_ok=True)
        paths: tp.List[Path] = []
        for u, utt in enumerate(utts):
            b = max(0.0, utt[0][1] - self.pad_s)
            e = min(total, utt[-1][2] + self.pad_s)
            if e - b < self.min_duration:
                continue
            text_ivs, last = [], 0.0
            for w, wb, we in utt:
                wb, we = max(wb - b, last), min(we - b, e - b)
                if wb > last:
                    text_ivs.append((last, wb, ""))
                text_ivs.append((wb, max(we, wb + 1e-3), w))
                last = max(we, wb + 1e-3)
            if last < e - b:
                text_ivs.append((last, e - b, ""))
            grid = TextGrid(0.0, e - b)
            grid.add(Tier("text", text_ivs))
            grid.add(Tier("orig", [(0.0, e - b, " ".join(w for w, _, _ in utt))]))
            seg = AudioSeg(AudioChunk(file_path=audio_path, begin=b, end=e), grid)
            n = start_index + len(paths)
            seg.meta = {
                "lang": self.lang,
                "speaker_name": self.speaker_name or audio_path.parent.name,
                "orig_audio_path": str(audio_path),
                "orig_audio_chunk": [b, e],
                "sent_position": ("first" if u == 0 else
                                  "last" if u == len(utts) - 1 else "internal"),
            }
            seg.audio_chunk.load()
            seg.meta["audio_chunk"] = [0.0, seg.audio_chunk.duration]
            seg.meta["audio_path"] = str(out_dir / f"{n}.wav")
            seg.save(out_dir / f"{n}.TextGrid", with_audio=True)
            paths.append(out_dir / f"{n}.TextGrid")
        return paths

    def run(self, data_root: tp.Union[str, Path], out_root: tp.Union[str, Path],
            ext: str = ".wav") -> tp.List[Path]:
        """Every ``ext`` file under ``data_root``, its utterances under the same
        relative directory of ``out_root``, numbered on across the files."""
        paths: tp.List[Path] = []
        for f in construct_file_list(data_root, ext=ext):
            out_dir = Path(out_root) / Path(f).relative_to(data_root).parent
            paths += self.process_file(f, out_dir=out_dir, start_index=len(paths))
        return paths
