"""Dataset parsers (counterpart of ``speechflow_tpu/data/parsers.py``):

Each derives from ``BaseDSParser`` (``data/core/parser.py``): ``reader(path)``
gives a file's metadata records, ``run_preprocessing(md)`` filters them,
``to_datasample(md)`` makes the sample.

- ``AudioDSParser``, the vocoder's: a file list -> audio samples whose
  speaker is read from the path;
- ``TTSDSParser``, the acoustic model's: TextGrid files (``AudioSeg``) ->
  samples with the text, the phonemes and their timestamps, the word tiers
  of the text parser and the utterance's audio window, after the duration,
  language and speaker filters;
- ``ProsodyParser``, the prosody model's: TextGrid files -> word-level
  samples with token ids and the ``prosody_targets`` of the ``prosody``
  tier (punctuation-driven where a file has none);
- ``SimpleDSParser``
  (a file list -> ``DataSample``, labelled by the parent directory),
  ``ImageDSParser`` (``.npy`` arrays -> ``ImageDataSample``), ``EasyDSParser``
  (any function over a file list; its result in ``additional["result"]``) and
  ``LibriSpeechDSParser`` (the MFA ``words`` / ``phones`` TextGrids of
  LibriSpeech-Alignments -> ``TTSDataSample``).

The audio is loaded by the ``load_audio`` handler, not here. A file that
fails to parse is skipped with a warning, as the JAX parser skips it.
"""

from __future__ import annotations

import logging
import typing as tp
from pathlib import Path

import numpy as np

from speechflow_torch.data.core.datasample import (
    DataSample,
    ImageDataSample,
    ProsodyPredictionDataSample,
    SpectrogramDataSample,
    TTSDataSample,
)
from speechflow_torch.data.core.parser import BaseDSParser, Metadata
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.io.seg import AudioSeg, TextGrid
from speechflow_torch.io.timestamps import Timestamps

__all__ = ["AudioDSParser", "TTSDSParser", "ProsodyParser", "SimpleDSParser", "ImageDSParser",
           "EasyDSParser", "LibriSpeechDSParser", "prosody_targets", "PARSERS"]

LOGGER = logging.getLogger("speechflow_torch")


class AudioDSParser(BaseDSParser):
    def reader(self, path: tp.Union[str, Path]) -> tp.List[Metadata]:
        return [{"path": str(path)}]

    @staticmethod
    def speaker_from_path(p: Path) -> str:
        """The first ancestor directory that is not a numeric shard or a
        generic name (``wavs``, ``wav``, ``audio``)."""
        for parent in p.parents:
            name = parent.name
            if name and not name.isdigit() and name.lower() not in ("wavs", "wav", "audio"):
                return name
        return p.parent.name

    def to_datasample(self, md: Metadata) -> SpectrogramDataSample:
        """A ``SpectrogramDataSample`` (an audio sample whose spectral fields are
        empty), so spectral handlers such as ``pitch`` run on a raw-audio corpus
        (the NSF vocoder's data)."""
        p = Path(md["path"])
        speaker = self.speaker_from_path(p)
        return SpectrogramDataSample(file_path=str(p), label=speaker, speaker_name=speaker,
                                     audio_chunk=AudioChunk(file_path=p))


class TTSDSParser(BaseDSParser):
    def __init__(self, max_duration: tp.Optional[float] = None,
                 min_duration: tp.Optional[float] = None,
                 max_phoneme_length: tp.Optional[float] = None,
                 audio_strip: bool = False, audio_strip_pad: float = 0.0,
                 languages: tp.Optional[tp.Sequence[str]] = None,
                 speakers: tp.Optional[tp.Sequence[str]] = None, **kwargs):
        super().__init__(**kwargs)
        self.max_duration = max_duration
        self.min_duration = min_duration
        self.max_phoneme_length = max_phoneme_length
        self.audio_strip = audio_strip
        self.audio_strip_pad = audio_strip_pad
        self.languages = set(languages) if languages else None
        self.speakers = set(speakers) if speakers else None

    def reader(self, path: tp.Union[str, Path]) -> tp.List[Metadata]:
        return [{"seg": AudioSeg.load(path), "path": str(path)}]

    def run_preprocessing(self, md: Metadata) -> tp.Optional[Metadata]:
        """The filters (language, speaker, duration bounds, no phoneme but a
        pause longer than ``max_phoneme_length``), then ``preproc_fns``; None
        drops the record."""
        seg: AudioSeg = md["seg"]
        if self.languages and seg.lang not in self.languages:
            return None
        if self.speakers and seg.speaker_name not in self.speakers:
            return None
        if self.max_duration and seg.duration > self.max_duration:
            return None
        if self.min_duration and seg.duration < self.min_duration:
            return None
        if self.max_phoneme_length:
            lens = [e - b for b, e, lab in seg.phonemes()
                    if lab and lab not in ("<SIL>", "undefined_sil")]
            if lens and max(lens) > self.max_phoneme_length:
                return None
        return super().run_preprocessing(md)

    def to_datasample(self, md: Metadata) -> TTSDataSample:
        seg: AudioSeg = md["seg"]
        path = md["path"]
        phs, words = seg.phonemes(), seg.words()
        chunk = seg.audio_chunk
        if self.audio_strip and words:
            # keep audio_strip_pad seconds of context on each side of the words
            b, e = seg.bos_eos_bounds()
            b = max(b - self.audio_strip_pad, 0.0)
            e = min(e + self.audio_strip_pad, seg.duration)
            chunk = AudioChunk(file_path=chunk.file_path, begin=chunk.begin + b,
                               end=chunk.begin + e)
            phs = [(pb - b, pe - b, lab) for pb, pe, lab in phs if pe > b and pb < e]
            words = [(wb - b, we - b, lab) for wb, we, lab in words]
        return TTSDataSample(
            file_path=str(path), sega_path=str(path), label=seg.speaker_name,
            audio_chunk=chunk, lang=seg.lang, speaker_name=seg.speaker_name,
            text=" ".join(lab for _, _, lab in words),
            phonemes=[lab for _, _, lab in phs],
            phoneme_timestamps=Timestamps(np.asarray([[b, e] for b, e, _ in phs]))
            if phs else None,
            word_timestamps=Timestamps(np.asarray([[b, e] for b, e, _ in words]))
            if words else None,
            intonation_type="?" if seg.text_ends_with("?") else ".",
            pos_tags=seg.word_tier_labels("pos"),
            syntax_rels=seg.word_tier_labels("rel"),
            word_ids=seg.word_tier_labels("id"),
            head_ids=seg.word_tier_labels("head_id"),
            emphasis_labels=seg.word_tier_labels("emphasis"),
            prosody_labels=seg.word_tier_labels("prosody"),
            syntagma_ids=seg.word_syntagma_ids(),
        )


def prosody_targets(words: tp.Sequence[str],
                    prosody_labels: tp.Optional[tp.Sequence[str]],
                    n_classes: int = 8) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Word-level prosody labels -> (binary, category) int32 targets. Empty,
    ``undefined`` and ``no`` are words without a contour (binary 0, category
    -1); a numeric label is a contour class (binary 1, category
    ``int(label) % n_classes``), any other label class 0. Without labels a
    word ending in ``,.?!`` counts as label "1", any other as undefined."""
    binary = np.zeros(len(words), np.int32)
    category = np.full(len(words), -1, np.int32)
    for k in range(len(words)):
        lab = (prosody_labels[k] if prosody_labels else
               ("1" if words[k][-1:] in ",.?!" else "undefined"))
        if lab in ("", "undefined", "no"):
            binary[k] = 0
        else:
            binary[k] = 1
            try:
                category[k] = int(lab) % n_classes
            except ValueError:
                category[k] = 0
    return binary, category


def seg_prosody_labels(seg: AudioSeg, n_words: int) -> tp.Optional[tp.List[str]]:
    """The non-empty labels of the ``prosody`` tier when there is one per word."""
    if "prosody" not in seg.grid:
        return None
    labels = seg.grid["prosody"].non_empty().labels
    return labels if len(labels) == n_words else None


class ProsodyParser(BaseDSParser):
    """TextGrid files -> ``ProsodyPredictionDataSample``: the words of the text
    tier, their ids (``word_ids``: a WordLM ``vocab`` or the hash vocabulary)
    and their ``prosody_targets``; a file without words gives no sample."""

    def __init__(self, vocab_size: int = 8000, vocab: tp.Optional[tp.Dict[str, int]] = None,
                 n_classes: int = 8, **kwargs):
        super().__init__(**kwargs)
        self.vocab_size = vocab_size
        self.vocab = vocab
        self.n_classes = n_classes

    def reader(self, path: tp.Union[str, Path]) -> tp.List[Metadata]:
        return [{"seg": AudioSeg.load(path), "path": str(path)}]

    def to_datasample(self, md: Metadata) -> tp.Optional[ProsodyPredictionDataSample]:
        from speechflow_torch.models.prosody.interface import word_ids

        seg: AudioSeg = md["seg"]
        words = [lab for _, _, lab in seg.words()]
        if not words:
            return None
        binary, category = prosody_targets(words, seg_prosody_labels(seg, len(words)),
                                           self.n_classes)
        return ProsodyPredictionDataSample(
            file_path=md["path"], label=seg.speaker_name, words=words,
            token_ids=word_ids(words, self.vocab, self.vocab_size), binary=binary,
            category=category)


class SimpleDSParser(BaseDSParser):
    def reader(self, path) -> tp.List[Metadata]:
        return [{"path": str(path)}]

    def to_datasample(self, md: Metadata) -> DataSample:
        return DataSample(file_path=md["path"], label=Path(md["path"]).parent.name)


class ImageDSParser(SimpleDSParser):
    """A ``.npy`` file's array as the image (other files: none), labelled by its
    parent directory."""

    def to_datasample(self, md: Metadata) -> ImageDataSample:
        path = md["path"]
        return ImageDataSample(file_path=path, label=Path(path).parent.name,
                               image=np.load(path) if path.endswith(".npy") else None)


class EasyDSParser(SimpleDSParser):
    """``fn(path)`` over a file list (in ``n_processes`` processes, so ``fn`` must
    pickle): a sample it returns is kept, None drops the file, any other result
    goes into ``additional["result"]`` of a ``DataSample``."""

    def __init__(self, fn: tp.Callable[[str], tp.Any], **kwargs):
        super().__init__(**kwargs)
        self.fn = fn

    def to_datasample(self, md: Metadata):
        out = self.fn(md["path"])
        if out is None or isinstance(out, DataSample):
            return out
        return DataSample(file_path=md["path"], additional={"result": out})


class LibriSpeechDSParser(BaseDSParser):
    """LibriSpeech-Alignments (MFA) TextGrids -> ``TTSDataSample``. Each word of
    the ``words`` tier takes the non-silent ``phones`` entries within it (1e-4 s
    of slack; ``spn`` becomes ``<UNK>``); silences between words are dropped (the
    ``add_pauses_from_timestamps`` handler puts the pauses back). A grid without
    either tier, words or phones, a word without phones, or out of the duration
    bounds gives no sample. The audio is the ``.flac`` or ``.wav`` beside the grid
    with ``-align`` taken out of its path; the speaker is the directory two up
    (``speaker/chapter/utterance``)."""

    SIL_LABELS = frozenset({"", "sil", "sp", "spn_sil", "<eps>"})

    def __init__(self, max_duration: tp.Optional[float] = None,
                 min_duration: tp.Optional[float] = None, **kwargs):
        super().__init__(**kwargs)
        self.max_duration = max_duration
        self.min_duration = min_duration

    def reader(self, path: tp.Union[str, Path]) -> tp.List[Metadata]:
        return [{"grid": TextGrid.load(path), "path": str(path)}]

    @staticmethod
    def resolve_audio(grid_path: Path) -> tp.Optional[Path]:
        base = Path(str(grid_path).replace("-align", ""))
        for suffix in (".flac", ".wav"):
            if base.with_suffix(suffix).exists():
                return base.with_suffix(suffix)
        return None

    def to_datasample(self, md: Metadata) -> tp.Optional[TTSDataSample]:
        grid, path = md["grid"], Path(md["path"])
        if "words" not in grid or "phones" not in grid:
            return None
        words = [iv for iv in grid["words"].intervals if iv[2]]
        phones = [iv for iv in grid["phones"].intervals
                  if iv[2].lower() not in self.SIL_LABELS]
        dur = grid.xmax - grid.xmin
        if not words or not phones or (self.max_duration and dur > self.max_duration) \
                or (self.min_duration and dur < self.min_duration):
            return None
        eps = 1e-4
        phonemes, ph_ts, word_lengths = [], [], []
        for wb, we, _ in words:
            inside = [(pb, pe, lab) for pb, pe, lab in phones
                      if pb >= wb - eps and pe <= we + eps]
            if not inside:
                return None  # a word without phones: a mis-parsed grid
            phonemes += ["<UNK>" if lab == "spn" else lab for _, _, lab in inside]
            ph_ts += [(pb, pe) for pb, pe, _ in inside]
            word_lengths.append(len(inside))
        audio = self.resolve_audio(path)
        if audio is None:
            return None
        speaker = path.parent.parent.name or path.parent.name
        return TTSDataSample(
            file_path=str(path), sega_path=str(path), label=speaker, speaker_name=speaker,
            lang="EN", audio_chunk=AudioChunk(file_path=audio),
            text=" ".join(lab for _, _, lab in words), phonemes=phonemes,
            phoneme_timestamps=Timestamps(np.asarray(ph_ts)),
            word_timestamps=Timestamps(np.asarray([[b, e] for b, e, _ in words])),
            word_lengths=np.asarray(word_lengths, np.int32))


PARSERS = {"TTSDSParser": TTSDSParser, "AudioDSParser": AudioDSParser,
           "SimpleDSParser": SimpleDSParser, "ImageDSParser": ImageDSParser,
           "EasyDSParser": EasyDSParser, "LibriSpeechDSParser": LibriSpeechDSParser,
           "ProsodyParser": ProsodyParser}
