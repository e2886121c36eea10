"""Text frontend: alphabet, phoneme tokenization, service tokens
(counterpart of ``speechflow_tpu/data/processors/text.py``).

An ``Alphabet`` maps tokens to stable ids with the service tokens first; a
``TextParserHook`` turns raw text into phonemes for inference (built in: the
character-level fallback, after ``text_norm.normalize_text``);
``G2PParserHook`` runs a trained G2P instead; ``TTSTextProcessor`` encodes
phonemes with BOS/EOS into the transcription. ``phonemize`` (the handler)
and ``phonemize_words`` give a sample that has text but no phoneme tier (the
seg generator's raw ``.TextGrid``, stage 1 of forced alignment) its phonemes,
word by word.
"""

from __future__ import annotations

import re
import typing as tp

import numpy as np

from speechflow_torch.data.core.datasample import TTSDataSample
from speechflow_torch.data.processors import handler

__all__ = ["Alphabet", "TTSTextProcessor", "TextParserHook", "G2PParserHook",
           "phonemize_words", "phonemize", "text_to_transcription", "to_ipa", "phonemes_to_ipa",
           "ARPABET_TO_IPA", "PAD", "BOS", "EOS", "SIL", "UNK", "SERVICE_TOKENS"]

PAD, BOS, EOS, SIL, UNK = "<PAD>", "<BOS>", "<EOS>", "<SIL>", "<UNK>"
SERVICE_TOKENS = (PAD, BOS, EOS, SIL, UNK)


class Alphabet:
    """Stable token<->id mapping with service tokens at fixed low ids."""

    def __init__(self, symbols: tp.Sequence[str]):
        self.symbols: tp.List[str] = list(SERVICE_TOKENS) + [
            s for s in sorted(set(symbols)) if s not in SERVICE_TOKENS
        ]
        self.index: tp.Dict[str, int] = {s: i for i, s in enumerate(self.symbols)}

    def __len__(self) -> int:
        return len(self.symbols)

    def __contains__(self, s: str) -> bool:
        return s in self.index

    def encode(self, tokens: tp.Sequence[str]) -> np.ndarray:
        unk = self.index[UNK]
        return np.asarray([self.index.get(t, unk) for t in tokens], dtype=np.int32)

    def decode(self, ids: tp.Sequence[int]) -> tp.List[str]:
        return [self.symbols[i] for i in ids]

    def to_dict(self) -> dict:
        return {"symbols": self.symbols}

    @staticmethod
    def from_dict(d: dict) -> "Alphabet":
        a = Alphabet([])
        a.symbols = list(d["symbols"])
        a.index = {s: i for i, s in enumerate(a.symbols)}
        return a

    @property
    def pad_id(self) -> int:
        return self.index[PAD]

    @property
    def sil_id(self) -> int:
        return self.index[SIL]

    @property
    def bos_id(self) -> int:
        return self.index[BOS]

    @property
    def eos_id(self) -> int:
        return self.index[EOS]


class TextParserHook:
    """Raw text -> phoneme sequence. The built-in fallback is a character
    tokenizer (lowercased, punctuation as pauses); every hook first expands
    digits and abbreviations through ``text_norm.normalize_text``."""

    PAUSE_CHARS = ".,;:!?—–-"

    @staticmethod
    def normalize(text: str, lang: str = "EN") -> str:
        from speechflow_torch.data.processors.text_norm import normalize_text

        return normalize_text(text, lang)

    def __call__(self, text: str, lang: str = "EN") -> tp.List[str]:
        out: tp.List[str] = []
        for ch in self.normalize(text, lang).strip().lower():
            if ch.isspace():
                continue
            out.append(SIL if ch in self.PAUSE_CHARS else ch)
        return out


class G2PParserHook(TextParserHook):
    """Raw text -> phonemes through a trained G2P (``models.g2p``: the mined
    lexicon first, the tagger for other words), pauses at punctuation."""

    _WORD_OR_PAUSE = re.compile(r"[\w']+|[" + re.escape(TextParserHook.PAUSE_CHARS) + r"]+")

    def __init__(self, g2p: tp.Any, device: tp.Any = None):
        """``g2p`` is a ``G2P`` or the path of a ``g2p.pkl``, loaded onto
        ``device`` (the GPU unless ``device="cpu"``)."""
        from speechflow_torch.models.g2p import G2P

        self.g2p = g2p if isinstance(g2p, G2P) else G2P.load(g2p, device=device)

    def __call__(self, text: str, lang: str = "EN") -> tp.List[str]:
        pieces = self._WORD_OR_PAUSE.findall(self.normalize(text, lang).strip().lower())
        words = [p for p in pieces if p[0] not in self.PAUSE_CHARS]
        prons = dict(zip(words, self.g2p.predict(words, lang)))
        out: tp.List[str] = []
        for p in pieces:
            if p[0] in self.PAUSE_CHARS:
                if not out or out[-1] != SIL:
                    out.append(SIL)
            else:
                out.extend(prons.get(p, ()))
        return out


def phonemize_words(text: str, hook: tp.Optional[TextParserHook] = None,
                    lang: str = "EN") -> tp.Tuple[tp.List[str], tp.List[int]]:
    """Raw text -> (phonemes, phonemes a word), word by word through ``hook``
    (the char fallback by default), punctuation stripped and pauses dropped:
    inserting pauses is ``add_pauses_from_text``'s job."""
    hook = hook or TextParserHook()
    phonemes: tp.List[str] = []
    counts: tp.List[int] = []
    for word in text.split():
        core = word.strip(hook.PAUSE_CHARS + "\"'()[]")
        if not core:
            continue
        phs = [p for p in hook(core, lang) if p != SIL]
        if not phs:
            continue
        phonemes.extend(phs)
        counts.append(len(phs))
    return phonemes, counts


@handler(inputs={"text"}, outputs={"phonemes", "word_lengths"})
def phonemize(ds: TTSDataSample, g2p: tp.Optional[str] = None,
              device: str = "cpu") -> TTSDataSample:
    """Text -> phonemes and ``word_lengths`` for a sample without a phoneme
    tier; a sample with phonemes, or without text, is left as it is. ``g2p``
    is a trained ``g2p.pkl`` (run on ``device``, the host by default: handlers
    run in the data workers); without it, the char fallback, whose symbols
    ``PhonemeStatistics`` counts for such a corpus."""
    if ds.phonemes or not ds.text:
        return ds
    hook = G2PParserHook(g2p, device=device) if g2p else TextParserHook()
    phs, counts = phonemize_words(ds.text, hook, ds.lang or "EN")
    ds.phonemes = phs
    ds.word_lengths = np.asarray(counts, dtype=np.int32)
    ds.phoneme_timestamps = None
    return ds


class TTSTextProcessor:
    """Stateful text frontend bound to an Alphabet."""

    def __init__(self, alphabet: tp.Optional[Alphabet] = None,
                 parser: tp.Optional[TextParserHook] = None,
                 add_service_tokens: bool = True):
        self.alphabet = alphabet
        self.parser = parser or TextParserHook()
        self.add_service_tokens = add_service_tokens

    def encode_phonemes(self, phonemes: tp.Sequence[str]) -> np.ndarray:
        toks = ["" if p is None else p for p in phonemes]
        toks = [SIL if t in ("", "undefined_sil") else t for t in toks]
        if self.add_service_tokens:
            toks = [BOS] + toks + [EOS]
        return self.alphabet.encode(toks)

    def encode_text(self, text: str, lang: str = "EN") -> np.ndarray:
        return self.encode_phonemes(self.parser(text, lang))

    def __call__(self, ds: TTSDataSample) -> TTSDataSample:
        return self.process(ds)

    def process(self, ds: TTSDataSample) -> TTSDataSample:
        if ds.phonemes is not None:
            ds.transcription = self.encode_phonemes(ds.phonemes)
        elif ds.text is not None:
            ds.transcription = self.encode_text(ds.text, ds.lang or "EN")
        ds.transform_params.setdefault("text", {}).update(
            alphabet_size=len(self.alphabet), add_service_tokens=self.add_service_tokens)
        return ds


@handler(inputs={"phonemes"}, outputs={"transcription"})
def text_to_transcription(ds: TTSDataSample,
                          processor: tp.Optional[TTSTextProcessor] = None) -> TTSDataSample:
    """Pipe-level wrapper; the pipeline binds ``processor``."""
    if processor is None:
        raise ValueError("text_to_transcription needs the pipeline's text processor "
                         "(the payload has no alphabet)")
    return processor.process(ds)


#: ARPABET -> IPA: multilingual recipes share one IPA symbol space; the stress
#: digits become IPA's stress marks, prefixed
ARPABET_TO_IPA: tp.Dict[str, str] = {
    "AA": "ɑ", "AE": "æ", "AH": "ʌ", "AO": "ɔ", "AW": "aʊ", "AY": "aɪ",
    "EH": "ɛ", "ER": "ɝ", "EY": "eɪ", "IH": "ɪ", "IY": "i", "OW": "oʊ",
    "OY": "ɔɪ", "UH": "ʊ", "UW": "u",
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "F": "f", "G": "ɡ",
    "HH": "h", "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n",
    "NG": "ŋ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ", "T": "t",
    "TH": "θ", "V": "v", "W": "w", "Y": "j", "Z": "z", "ZH": "ʒ",
}
_STRESS_MARKS = {"1": "ˈ", "2": "ˌ", "0": ""}


def to_ipa(phoneme: str) -> str:
    """One ARPABET phoneme, with or without its stress digit ("AA1"), in IPA;
    service tokens and unknown symbols unchanged."""
    if phoneme in SERVICE_TOKENS:
        return phoneme
    base, stress = phoneme, ""
    if base and base[-1] in _STRESS_MARKS:
        stress, base = _STRESS_MARKS[base[-1]], base[:-1]
    ipa = ARPABET_TO_IPA.get(base.upper())
    return phoneme if ipa is None else stress + ipa


def phonemes_to_ipa(phonemes: tp.Sequence[str]) -> tp.List[str]:
    return [to_ipa(p) for p in phonemes]
