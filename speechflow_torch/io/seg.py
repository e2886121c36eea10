"""Praat TextGrids and annotated utterances (counterpart of
``speechflow_tpu/io/seg.py``): short-form ``ooTextFile`` TextGrids with
interval tiers (the ``.TextGridStage3`` files of ``tests/data/SEGS``:
orig/syntagmas/text/stress/phonemes/pos/rel/id/head_id/emphasis/prosody/meta),
read from the Praat file-format spec and written as the JAX package writes
them (``TextGrid.dumps``/``save``: numbers with at most six decimals, quotes
doubled), and ``AudioSeg``, an utterance's audio window, tiers and ``meta``
dict (lang, speaker_name, audio_chunk), as the TTS parser reads it and the
annotator's aligner writes it (``AudioSeg.save``: the meta dict as the
``meta`` tier's python literal). Text only.
"""

from __future__ import annotations

import ast
import typing as tp
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.io.timestamps import Timestamps

__all__ = ["Tier", "TextGrid", "AudioSeg"]

Interval = tp.Tuple[float, float, str]


@dataclass
class Tier:
    name: str
    intervals: tp.List[Interval] = field(default_factory=list)

    def non_empty(self) -> "Tier":
        return Tier(self.name, [iv for iv in self.intervals if iv[2] != ""])

    @property
    def labels(self) -> tp.List[str]:
        return [iv[2] for iv in self.intervals]

    @property
    def timestamps(self) -> Timestamps:
        return Timestamps([[b, e] for b, e, _ in self.intervals])

    def shift(self, offset: float) -> "Tier":
        return Tier(self.name, [(b + offset, e + offset, t) for b, e, t in self.intervals])

    def window(self, begin: float, end: float) -> "Tier":
        """Intervals overlapping [begin, end), clipped and re-origined to 0."""
        return Tier(self.name, [(max(b, begin) - begin, min(e, end) - begin, t)
                                for b, e, t in self.intervals if e > begin and b < end])


class TextGrid:
    """Short-form ooTextFile TextGrid with interval tiers only."""

    def __init__(self, xmin: float = 0.0, xmax: float = 0.0,
                 tiers: tp.Optional[tp.List[Tier]] = None):
        self.xmin = xmin
        self.xmax = xmax
        self.tiers: tp.List[Tier] = tiers or []

    def __getitem__(self, name: str) -> Tier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(t.name == name for t in self.tiers)

    @property
    def tier_names(self) -> tp.List[str]:
        return [t.name for t in self.tiers]

    def add(self, tier: Tier) -> "TextGrid":
        """Add ``tier`` last, replacing a tier of the same name; ``xmax`` grows
        to the tier's last end."""
        self.tiers = [t for t in self.tiers if t.name != tier.name] + [tier]
        if tier.intervals:
            self.xmax = max(self.xmax, *(iv[1] for iv in tier.intervals))
        return self

    # -- parsing ---------------------------------------------------------------

    @staticmethod
    def load(path: tp.Union[str, Path]) -> "TextGrid":
        return TextGrid.loads(Path(path).read_text(encoding="utf-8"))

    @staticmethod
    def loads(text: str) -> "TextGrid":
        toks = _tokenize(text)
        it = iter(toks)

        def nxt():
            return next(it)

        header = nxt()  # File type
        if "ooTextFile" not in str(header):
            raise ValueError("not an ooTextFile TextGrid")
        nxt()  # Object class
        xmin = float(nxt())
        xmax = float(nxt())
        exists = nxt()
        tiers: tp.List[Tier] = []
        if str(exists) == "<exists>":
            n_tiers = int(nxt())
            for _ in range(n_tiers):
                klass = str(nxt())
                name = str(nxt())
                nxt()  # tier xmin
                nxt()  # tier xmax
                n = int(nxt())
                intervals = []
                if klass == "IntervalTier":
                    for _ in range(n):
                        b = float(nxt()); e = float(nxt()); lab = str(nxt())
                        intervals.append((b, e, lab))
                else:  # TextTier (points): store as zero-width intervals
                    for _ in range(n):
                        t = float(nxt()); lab = str(nxt())
                        intervals.append((t, t, lab))
                tiers.append(Tier(name, intervals))
        return TextGrid(xmin, xmax, tiers)

    # -- writing ----------------------------------------------------------------

    def dumps(self) -> str:
        lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', ""]
        lines += [_num(self.xmin), _num(self.xmax), "<exists>", str(len(self.tiers))]
        for tier in self.tiers:
            lines += ['"IntervalTier"', f'"{tier.name}"']
            lines += [_num(self.xmin), _num(self.xmax), str(len(tier.intervals))]
            for b, e, lab in tier.intervals:
                lines += [_num(b), _num(e), '"%s"' % lab.replace('"', '""')]
        return "\n".join(lines) + "\n"

    def save(self, path: tp.Union[str, Path]) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.dumps(), encoding="utf-8")


def _num(x: float) -> str:
    s = f"{x:.6f}".rstrip("0").rstrip(".")
    return s if s else "0"


def _tokenize(text: str) -> tp.List[str]:
    """Yield TextGrid tokens: quoted strings (with '""' escapes) or bare words."""
    toks: tp.List[str] = []
    i, n = 0, len(text)
    # skip the two header lines verbatim
    lines = text.split("\n")
    body_start = 0
    hdr = []
    for li, line in enumerate(lines):
        if line.startswith("File type") or line.startswith("Object class"):
            hdr.append(line)
            body_start = li + 1
        if len(hdr) == 2:
            break
    toks.extend(hdr)
    body = "\n".join(lines[body_start:])
    i, n = 0, len(body)
    while i < n:
        c = body[i]
        if c.isspace():
            i += 1
        elif c == '"':
            j = i + 1
            buf = []
            while j < n:
                if body[j] == '"':
                    if j + 1 < n and body[j + 1] == '"':
                        buf.append('"'); j += 2
                    else:
                        j += 1
                        break
                else:
                    buf.append(body[j]); j += 1
            toks.append("".join(buf))
            i = j
        else:
            j = i
            while j < n and not body[j].isspace():
                j += 1
            toks.append(body[i:j])
            i = j
    return toks


class AudioSeg:
    """One annotated utterance: audio window + tier annotations + meta dict.

    The ``meta`` tier carries a python-literal dict (lang, speaker_name,
    audio_chunk, ...); the ``text``/``phonemes``/``syntagmas`` tiers carry the
    aligned annotation; BOS/EOS are the leading/trailing empty intervals.
    """

    SERVICE_TIERS = ("meta",)

    def __init__(self, audio_chunk: AudioChunk, grid: tp.Optional[TextGrid] = None):
        self.audio_chunk = audio_chunk
        self.grid = grid or TextGrid()
        self.meta: tp.Dict[str, tp.Any] = {}
        if grid is not None and "meta" in grid:
            labels = [iv[2] for iv in grid["meta"].intervals if iv[2]]
            if labels:
                try:
                    self.meta = ast.literal_eval(labels[0])
                except (ValueError, SyntaxError):
                    self.meta = {"raw": labels[0]}

    # -- loading -------------------------------------------------------------

    @staticmethod
    def load(path: tp.Union[str, Path],
             audio_path: tp.Optional[tp.Union[str, Path]] = None,
             load_audio: bool = False) -> "AudioSeg":
        """The TextGrid at ``path`` and the window of ``audio_path``, by default
        its sibling wav with the same stem ("0.TextGridStage3" -> "0.wav"); the
        samples are read only with ``load_audio``."""
        path = Path(path)
        grid = TextGrid.load(path)
        seg = AudioSeg(AudioChunk(file_path=path), grid)  # placeholder chunk
        if audio_path is None:
            audio_path = path.parent / f"{path.name.split('.')[0]}.wav"
        chunk = seg.meta.get("audio_chunk", [grid.xmin, grid.xmax])
        seg.audio_chunk = AudioChunk(file_path=audio_path, begin=chunk[0], end=chunk[1])
        if load_audio:
            seg.audio_chunk.load()
        return seg

    @staticmethod
    def _plain(v):
        """numpy scalars and arrays, tuples and paths as python literals, so the
        meta dict's repr reads back with ``ast.literal_eval``."""
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, dict):
            return {k: AudioSeg._plain(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [AudioSeg._plain(x) for x in v]
        if isinstance(v, Path):
            return str(v)
        return v

    def save(self, path: tp.Union[str, Path], with_audio: bool = False) -> None:
        """The grid with the meta dict as its last tier (``meta``), at ``path``;
        with ``with_audio`` also the audio chunk's waveform as the wav beside it,
        named by the grid's name before its first ``.``."""
        self.meta = self._plain(self.meta)
        self.grid.add(Tier("meta", [(self.grid.xmin, self.grid.xmax, repr(self.meta))]))
        self.grid.save(path)
        if with_audio:
            path = Path(path)
            self.audio_chunk.save(path.parent / f"{path.name.split('.')[0]}.wav",
                                  overwrite=True)

    # -- views -----------------------------------------------------------------

    @property
    def lang(self) -> str:
        return self.meta.get("lang", "")

    @property
    def speaker_name(self) -> str:
        return self.meta.get("speaker_name", "")

    @property
    def duration(self) -> float:
        return self.grid.xmax - self.grid.xmin

    def tier(self, name: str) -> Tier:
        return self.grid[name]

    def words(self) -> tp.List[Interval]:
        return self.grid["text"].non_empty().intervals if "text" in self.grid else []

    def phonemes(self) -> tp.List[Interval]:
        return self.grid["phonemes"].intervals if "phonemes" in self.grid else []

    def word_tier_labels(self, name: str) -> tp.Optional[tp.List[str]]:
        """Labels of a word-aligned tier (pos/rel/id/head_id/emphasis/prosody)
        at the word positions — the indices where the ``text`` tier is
        non-empty (all word-level tiers share the text tier's segmentation in
        reference segas)."""
        if name not in self.grid or "text" not in self.grid:
            return None
        text_ivs = self.grid["text"].intervals
        tier_ivs = self.grid[name].intervals
        if len(tier_ivs) != len(text_ivs):
            # fall back to timestamp matching against the word midpoints
            words = self.words()
            out = []
            for b, e, _ in words:
                mid = 0.5 * (b + e)
                lab = ""
                for tb, te, tl in tier_ivs:
                    if tb - 1e-6 <= mid <= te + 1e-6:
                        lab = tl
                        break
                out.append(lab)
            return out
        return [tier_ivs[i][2] for i, iv in enumerate(text_ivs) if iv[2]]

    def word_syntagma_ids(self) -> tp.Optional[tp.List[int]]:
        """Syntagma index per word (by word midpoint containment)."""
        if "syntagmas" not in self.grid:
            return None
        synt = self.grid["syntagmas"].non_empty().intervals
        out = []
        for b, e, _ in self.words():
            mid = 0.5 * (b + e)
            idx = 0
            for j, (sb, se, _) in enumerate(synt):
                if sb - 1e-6 <= mid <= se + 1e-6:
                    idx = j
                    break
            out.append(idx)
        return out

    def phoneme_labels(self) -> tp.List[str]:
        return [lab for _, _, lab in self.phonemes()]

    def phoneme_timestamps(self) -> Timestamps:
        return Timestamps([[b, e] for b, e, _ in self.phonemes()])

    def bos_eos_bounds(self) -> tp.Tuple[float, float]:
        """(leading silence end, trailing silence begin) from the text tier."""
        words = self.words()
        if not words:
            return (self.grid.xmin, self.grid.xmax)
        return (words[0][0], words[-1][1])

    def text_ends_with(self, suffix: str) -> bool:
        """Whether the last word's label ends with ``suffix``."""
        words = self.words()
        return bool(words) and words[-1][2].strip().endswith(suffix)

    def split_into_syntagmas(self) -> tp.List["AudioSeg"]:
        """One utterance a non-empty ``syntagmas`` interval: every tier but the
        service ones windowed to it and re-origined to 0, the audio window cut to
        it, the meta dict with ``sent_position`` the syntagma's label. Without a
        ``syntagmas`` tier, ``[self]``."""
        if "syntagmas" not in self.grid:
            return [self]
        out = []
        for b, e, lab in self.grid["syntagmas"].non_empty().intervals:
            sub = TextGrid(0.0, e - b)
            for t in self.grid.tiers:
                if t.name not in self.SERVICE_TIERS:
                    sub.add(t.window(b, e))
            chunk = AudioChunk(file_path=self.audio_chunk.file_path,
                               begin=self.audio_chunk.begin + b, end=self.audio_chunk.begin + e)
            seg = AudioSeg(chunk, sub)
            seg.meta = dict(self.meta, sent_position=lab)
            out.append(seg)
        return out
