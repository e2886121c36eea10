"""TTS inference interface (counterpart of
``speechflow_tpu/interface/tts_interface.py``): raw text, plain or SSML, to
the acoustic model's output.

The interface rebuilds the text path from the checkpoint's payload: the
data pipeline (``pipeline_info``) with the audio handlers dropped, the
alphabet, the speaker and language maps and mean embeddings of the singleton
states, and a trained G2P (``g2p.pkl`` beside the checkpoint) or the
character-level fallback. Then ``synthesize(text)`` runs
split_sentences -> prepare_text -> predict_pauses -> prepare_embeddings ->
prepare_batch -> evaluate; feed the output to the vocoder interface for a
waveform.

``from_checkpoint(tree, payload)`` takes what the JAX
``ExperimentSaver.load_checkpoint`` returns (the port does not read orbax
files yet); the constructor takes a built model and a payload. Not ported
yet, each raising ``NotImplementedError``: reference-audio embeddings (voice
biometrics), a prosody model (``prosody_ckpt``), ``resynthesize`` (the audio
pipeline), and models with ``use_prosody``.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import typing as tp
from pathlib import Path

import numpy as np
import torch

from speechflow_torch.convert import load_nnx_state
from speechflow_torch.data.core.components import DataPipeline
from speechflow_torch.data.core.datasample import TTSDataSample
from speechflow_torch.data.processors.ling import (
    _expand,
    lm_feat_for_words,
    word_ling_features,
)
from speechflow_torch.data.processors.ssml import apply_ssml_modifiers, parse_ssml
from speechflow_torch.data.processors.text import (
    SIL,
    G2PParserHook,
    TextParserHook,
    TTSTextProcessor,
)
from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams, TTSForwardInput
from speechflow_torch.models.tts.batch_processor import TTSBatchProcessor
from speechflow_torch.models.tts.data_types import TTSOutput
from speechflow_torch.utils.device import resolve_device

__all__ = ["TTSEvaluationInterface", "TTSContext", "TTSOptions", "ProsodyReference",
           "AUDIO_HANDLERS"]

#: handlers of a training pipe that need audio or timestamps: dropped for raw text
AUDIO_HANDLERS = {
    "load_audio", "volume_normalize", "multiple_audio", "magnitude",
    "linear_to_mel", "amp_to_db", "normalize_mel", "energy", "pitch",
    "calc_durations", "aggregate_pitch", "aggregate_energy", "gate_target",
    "add_pauses_from_timestamps",
    # ling/lm features are computed inline at inference (no timestamps exist)
    "add_ling_feat", "add_lm_feat",
}


@dataclasses.dataclass
class ProsodyReference:
    """The speaker reference of a request: its name and id, and the catalog
    mean embedding (a reference-audio embedding and its style mel need voice
    biometrics, not ported yet)."""

    speaker_name: tp.Optional[str] = None
    speaker_id: int = 0
    speaker_emb: tp.Optional[np.ndarray] = None
    speaker_emb_mean: tp.Optional[np.ndarray] = None

    def initialize(self, speaker2id: tp.Dict[str, int],
                   mean_embs: tp.Dict[str, np.ndarray]) -> "ProsodyReference":
        if self.speaker_name is not None:
            self.speaker_id = speaker2id.get(self.speaker_name, self.speaker_id)
            if self.speaker_emb_mean is None and self.speaker_name in mean_embs:
                self.speaker_emb_mean = np.asarray(mean_embs[self.speaker_name], np.float32)
        if self.speaker_emb is None:
            self.speaker_emb = self.speaker_emb_mean
        return self


@dataclasses.dataclass
class TTSContext:
    lang: str = "EN"
    speaker_name: tp.Optional[str] = None
    speaker_id: int = 0
    lang_id: int = 0
    prosody_reference: ProsodyReference = dataclasses.field(default_factory=ProsodyReference)

    @property
    def speaker_emb(self) -> tp.Optional[np.ndarray]:
        return self.prosody_reference.speaker_emb


@dataclasses.dataclass
class TTSOptions:
    t_out: int = 1024
    cfm_timesteps: tp.Optional[int] = None
    begin_pause: bool = True        # SIL at utterance start
    end_pause: bool = True          # SIL at utterance end
    pause_level: str = "punctuation"  # punctuation | words | none


def _service_pad(mat: np.ndarray, ds: TTSDataSample, sil_row: bool) -> np.ndarray:
    if ds.n_tokens == mat.shape[0] + 2:
        row = np.zeros((1, mat.shape[1]), mat.dtype)
        if sil_row:
            row[0, 0] = 1.0
        mat = np.concatenate([row, mat, row.copy()], axis=0)
    return mat


class TTSEvaluationInterface:
    def __init__(self, model: ParallelTTSModel, payload: tp.Mapping,
                 text_parser: tp.Optional[TextParserHook] = None,
                 g2p_ckpt: tp.Optional[tp.Union[str, Path]] = None,
                 ckpt_path: tp.Optional[tp.Union[str, Path]] = None,
                 prosody_ckpt: tp.Optional[tp.Union[str, Path]] = None):
        """``model`` with its weights loaded, on its device and in its dtype;
        ``payload`` as a trainer stores it (``pipeline_info``). Raw text goes
        through ``text_parser``, else the G2P at ``g2p_ckpt``, else a
        ``g2p.pkl`` found beside ``ckpt_path``, else the char fallback."""
        if prosody_ckpt is not None:
            raise NotImplementedError("the prosody model interface is not ported yet")
        self.model = model.eval()
        self.params = model.p
        p = next(model.parameters())
        self.device, self.dtype = p.device, p.dtype
        self.payload = dict(payload)
        info = payload["pipeline_info"]
        self.pipeline = DataPipeline.from_info(info, ignored_handlers=AUDIO_HANDLERS)
        self.alphabet = self.pipeline.alphabet
        if text_parser is None:
            text_parser = self._discover_g2p(ckpt_path, g2p_ckpt, self.device)
        self.text_processor = TTSTextProcessor(self.alphabet, parser=text_parser)
        self.batch_processor = TTSBatchProcessor()

        singles = self.pipeline.singletons
        spk = singles.get("SpeakerIDSetter", {})
        self.speaker2id: tp.Dict[str, int] = dict(spk.get("speaker2id", {}))
        self.lang2id: tp.Dict[str, int] = dict(spk.get("lang2id", {}))
        self.mean_bio_embs: tp.Dict[str, np.ndarray] = {
            k: np.asarray(v, np.float32)
            for k, v in singles.get("MeanBioEmbeddings", {}).get("mean_emb", {}).items()}
        self.speaker_durations: tp.Dict[str, float] = singles.get(
            "DatasetStatistics", {}).get("speaker_durations", {})

    @classmethod
    def from_checkpoint(cls, tree: tp.Mapping, payload: tp.Mapping,
                        ckpt_path: tp.Optional[tp.Union[str, Path]] = None,
                        device: tp.Union[str, torch.device, None] = None,
                        dtype: torch.dtype = torch.float32,
                        **kwargs) -> "TTSEvaluationInterface":
        """Rebuild the acoustic model from ``(tree, payload)`` of a checkpoint
        on ``device`` (the GPU unless ``device="cpu"``) in ``dtype``;
        ``ckpt_path`` (the checkpoint's directory) is where a ``g2p.pkl`` is
        looked for. Other keywords go to the constructor."""
        dev = resolve_device(device)
        model = ParallelTTSModel(ParallelTTSParams.create(payload["model_params"]))
        load_nnx_state(model, tree["model"])
        return cls(model.to(dev, dtype), payload, ckpt_path=ckpt_path, **kwargs)

    @staticmethod
    def _discover_g2p(ckpt_path: tp.Optional[tp.Union[str, Path]],
                      g2p_ckpt: tp.Optional[tp.Union[str, Path]],
                      device: torch.device) -> tp.Optional[TextParserHook]:
        """An explicit path wins, else ``g2p.pkl`` in the checkpoint's
        directory or the two above it (where the train CLIs save it). Without
        one the char-level tokenizer is used, with a warning: char tokens are
        out of distribution for a phoneme-trained model."""
        if g2p_ckpt:
            candidates = [Path(g2p_ckpt)]
        elif ckpt_path is not None:
            ckpt = Path(ckpt_path)
            candidates = [ckpt / "g2p.pkl", ckpt.parent / "g2p.pkl",
                          ckpt.parent.parent / "g2p.pkl"]
        else:
            candidates = []
        for c in candidates:
            if c.is_file():
                return G2PParserHook(c, device=device)
        logging.getLogger("speechflow_torch").warning(
            "no trained G2P found near %s: raw-text synthesis uses the char-level "
            "fallback", ckpt_path)
        return None

    # -- catalog --------------------------------------------------------------

    def get_languages(self) -> tp.List[str]:
        return sorted(self.lang2id)

    def get_speakers(self, hours_per_speaker: tp.Optional[
            tp.Union[float, tp.Tuple[float, float]]] = None) -> tp.List[str]:
        """Optionally only speakers with more hours of audio than a number,
        or between two numbers."""
        if hours_per_speaker and self.speaker_durations:
            hours = {k: v / 3600.0 for k, v in self.speaker_durations.items()}
            if isinstance(hours_per_speaker, (int, float)):
                names = [k for k, v in hours.items() if v > hours_per_speaker]
            else:
                lo, hi = hours_per_speaker
                names = [k for k, v in hours.items() if lo < v < hi]
            return sorted(names)
        return sorted(self.speaker2id)

    # -- text frontend ---------------------------------------------------------

    def split_sentences(self, text: str) -> tp.List[str]:
        parts = re.split(r"(?<=[.!?;])\s+", text.strip())
        return [p for p in parts if p]

    def prepare_text(self, text: str, lang: str = "EN") -> tp.List[str]:
        return self.text_processor.parser(text, lang)

    def predict_pauses(self, words: tp.Sequence[str],
                       opts: tp.Optional[TTSOptions] = None) -> tp.List[bool]:
        """True at word i: a SIL after word i (at punctuation, after every
        word, or never, by ``opts.pause_level``; the end pause is
        ``prepare_batch``'s)."""
        opts = opts or TTSOptions()
        out = []
        for w in words:
            if opts.pause_level == "words":
                out.append(True)
            elif opts.pause_level == "punctuation":
                out.append(bool(w) and not w[-1].isalnum())
            else:
                out.append(False)
        if out:
            out[-1] = False
        return out

    # -- embeddings ------------------------------------------------------------

    def prepare_embeddings(self, ctx: TTSContext, ref_audio=None) -> TTSContext:
        """The catalog mean embedding of the context's speaker."""
        if ref_audio is not None:
            raise NotImplementedError(
                "reference-audio embeddings need voice biometrics (ECAPA), not ported yet")
        ref = ctx.prosody_reference
        ref.speaker_name = ref.speaker_name or ctx.speaker_name
        ref.initialize(self.speaker2id, self.mean_bio_embs)
        return ctx

    # -- batch construction ------------------------------------------------------

    def create_context(self, lang: str = "EN", speaker: tp.Optional[str] = None) -> TTSContext:
        ctx = TTSContext(lang=lang, speaker_name=speaker)
        ctx.lang_id = self.lang2id.get(lang, 0)
        if speaker is not None:
            ctx.speaker_id = self.speaker2id.get(speaker, 0)
            ctx.prosody_reference.speaker_name = speaker
            ctx.prosody_reference.speaker_id = ctx.speaker_id
        return ctx

    def _sample(self, sent: str, ctx: TTSContext) -> TTSDataSample:
        return TTSDataSample(text=sent, lang=ctx.lang, speaker_name=ctx.speaker_name,
                             speaker_id=ctx.speaker_id, lang_id=ctx.lang_id,
                             speaker_emb=ctx.speaker_emb)

    def _build_plain_sample(self, sent: str, ctx: TTSContext,
                            opts: TTSOptions) -> TTSDataSample:
        """Word-by-word G2P, the pause plan, and the ling/LM features."""
        words = sent.split()
        pauses_after = self.predict_pauses(words, opts)
        phonemes: tp.List[str] = []
        word_map: tp.List[int] = []       # word index per phoneme (-1 = SIL)
        word_lengths: tp.List[int] = []
        if opts.begin_pause:
            phonemes.append(SIL)
            word_map.append(-1)
            word_lengths.append(1)
        for i, w in enumerate(words):
            toks = [t for t in self.prepare_text(w, ctx.lang) if t != SIL]
            if not toks:
                continue
            phonemes.extend(toks)
            word_map.extend([i] * len(toks))
            word_lengths.append(len(toks))
            if pauses_after[i] or (opts.end_pause and i == len(words) - 1):
                phonemes.append(SIL)
                word_map.append(-1)
                word_lengths.append(1)

        ds = self._sample(sent, ctx)
        ds.phonemes = phonemes
        ds.transcription = self.text_processor.encode_phonemes(phonemes)
        intonation = sent.rstrip()[-1:] if sent.rstrip()[-1:] in "?!" else "."
        if self.params.use_ling_feat:
            wf = word_ling_features(words, intonation=intonation)
            ds.ling_feat = _service_pad(_expand(wf, np.asarray(word_map), phonemes), ds,
                                        sil_row=True)
        if self.params.use_lm_feat:
            wf = lm_feat_for_words(words)
            mat = np.zeros((len(phonemes), wf.shape[1]), np.float32)
            for i, w in enumerate(word_map):
                if w >= 0:
                    mat[i] = wf[w]
            ds.lm_feat = _service_pad(mat, ds, sil_row=False)
        wl = list(word_lengths)
        if ds.n_tokens == sum(wl) + 2:
            wl = [1] + wl + [1]
        ds.word_lengths = np.asarray(wl, np.int32)
        return ds

    def _build_ssml_sample(self, sent: str, ctx: TTSContext) -> TTSDataSample:
        ds = self._sample(sent, ctx)
        plain, words = parse_ssml(sent)
        phonemes, word_lengths = [], []
        for word, _ in words:
            toks = self.prepare_text(word, ctx.lang)
            phonemes.extend(toks)
            word_lengths.append(len(toks))
        ds.text = plain
        ds.phonemes = phonemes
        ds.word_lengths = np.asarray(word_lengths, np.int32)
        ds.transcription = self.text_processor.encode_phonemes(phonemes)
        if len(ds.transcription) == sum(word_lengths) + 2:
            ds.word_lengths = np.concatenate([[1], ds.word_lengths, [1]]).astype(np.int32)
            words = [("<BOS>", {})] + words + [("<EOS>", {})]
        ds.additional["ssml"] = words
        return apply_ssml_modifiers(ds)

    def prepare_batch(self, sentences: tp.Sequence[str], ctx: TTSContext,
                      opts: TTSOptions) -> TTSForwardInput:
        """One sample a sentence (SSML where it has a ``<prosody`` span),
        through the pipeline's handlers and collate; the inputs on the model's
        device, floats in its dtype (the SSML modifiers stay float32)."""
        samples = [self._build_ssml_sample(s, ctx) if "<prosody" in s
                   else self._build_plain_sample(s, ctx, opts) for s in sentences]
        inputs, _ = self.batch_processor(self.pipeline.datasample_to_batch(samples))
        return inputs.to(self.device, self.dtype)

    # -- inference ----------------------------------------------------------------

    @torch.inference_mode()
    def evaluate(self, inputs: TTSForwardInput, opts: tp.Optional[TTSOptions] = None,
                 noise: tp.Optional[torch.Tensor] = None,
                 generator: tp.Optional[torch.Generator] = None) -> TTSOutput:
        """The acoustic model on prepared inputs, ``opts.t_out`` frames.
        ``noise`` is the CFM's initial state (scaled by the temperature),
        else it is drawn from ``generator``."""
        opts = opts or TTSOptions()
        if noise is not None:
            noise = noise.to(self.device)
        return self.model(inputs.to(self.device, self.dtype), t_out=opts.t_out, noise=noise,
                          generator=generator, cfm_timesteps=opts.cfm_timesteps)

    def synthesize(self, text: str, lang: str = "EN", speaker: tp.Optional[str] = None,
                   ref_audio=None, opts: tp.Optional[TTSOptions] = None,
                   noise: tp.Optional[torch.Tensor] = None,
                   generator: tp.Optional[torch.Generator] = None) -> TTSOutput:
        """Text -> the acoustic model's output, a sentence a batch row. SSML
        text is one utterance: splitting would cut across its spans."""
        opts = opts or TTSOptions()
        ctx = self.prepare_embeddings(self.create_context(lang, speaker), ref_audio)
        sentences = [text] if "<prosody" in text else self.split_sentences(text)
        return self.evaluate(self.prepare_batch(sentences, ctx, opts), opts, noise, generator)

    def resynthesize(self, *args, **kwargs) -> TTSOutput:
        raise NotImplementedError("resynthesize needs the audio pipeline, not ported yet")
