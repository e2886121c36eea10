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

``from_checkpoint(tree, payload)`` takes what a checkpoint loader returns
(``training.saver.ExperimentSaver.load_checkpoint``, which reads the port's
checkpoints and the JAX trainer's orbax ones); the constructor takes a built
model and a payload.

The rest of the reference's chain:

- ``prosody_ckpt`` (a port checkpoint directory of ``train_prosody``, or a
  built ``ProsodyPredictionInterface``): ``predict_prosody_by_text`` gives
  each word its contour class (-1 where the model sees none, or without a
  model, or with ``TTSOptions.use_prosody_model`` off), and a model with
  ``use_prosody`` gets the classes as a per-phoneme row;
- ``prepare_embeddings(ctx, ref_audio)``: the reference wav at the pipeline's
  sample rate through ``voice_biometrics`` (the speaker embedding) and the
  host's normalised log-mel (the style mel, which ``prepare_batch`` gives every
  row as ``inputs.mel``);
- ``resynthesize(sega)``: an annotated utterance through the full pipeline of
  ``pipeline_info`` (audio handlers included), optionally with a reference's
  speaker embedding and style mel; ``t_out`` is the source's frames.

Two behaviours are the reference's and kept: ``prepare_embeddings`` calls
``voice_biometrics`` with its defaults, so a reference wav gets the handler's
fallback embedding unless a process-wide ``set_biometric_model`` hook is set,
whatever ``model_ckpt`` the training pipe gave that handler; and raw text gets
the hashed LM features (``lm_feat_for_words(words)``), whatever WordLM the
training pipe's ``add_lm_feat`` read.
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
from speechflow_torch.data.processors import np_dsp
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
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.models.prosody.interface import ProsodyPredictionInterface
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
    """The speaker reference of a request: its name and id, the embedding of a
    reference wav (else the catalog mean embedding) and the reference's mel
    for the style encoder."""

    speaker_name: tp.Optional[str] = None
    speaker_id: int = 0
    speaker_emb: tp.Optional[np.ndarray] = None
    speaker_emb_mean: tp.Optional[np.ndarray] = None
    style_mel: tp.Optional[np.ndarray] = None

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
    #: JAX's fields, which nothing reads there or here: a value is warned of
    prosody_classes: tp.Optional[tp.Dict[str, np.ndarray]] = None
    seed: int = 0

    def __post_init__(self):
        if self.prosody_classes is not None or self.seed != 0:
            logging.getLogger("speechflow_torch").warning(
                "TTSContext: prosody_classes and seed are read by nothing (as in JAX); "
                "pass prosody through prosody_reference and draws through a generator")

    @property
    def speaker_emb(self) -> tp.Optional[np.ndarray]:
        return self.prosody_reference.speaker_emb

    @property
    def style_mel(self) -> tp.Optional[np.ndarray]:
        return self.prosody_reference.style_mel


@dataclasses.dataclass
class TTSOptions:
    t_out: int = 1024
    cfm_timesteps: tp.Optional[int] = None
    max_tokens: int = 256           # JAX's field; read by nothing, as there: warned of
    begin_pause: bool = True        # SIL at utterance start
    end_pause: bool = True          # SIL at utterance end
    pause_level: str = "punctuation"  # punctuation | words | none
    use_prosody_model: bool = True

    def __post_init__(self):
        if self.max_tokens != 256:
            logging.getLogger("speechflow_torch").warning(
                "TTSOptions.max_tokens is read by nothing (as in JAX); t_out sets the length")


def _with_style_mel(inputs: TTSForwardInput, style_mel: np.ndarray, batch: int
                    ) -> TTSForwardInput:
    """``inputs`` with the style mel (T, n_mels) as every row's ``mel``."""
    style = torch.from_numpy(np.asarray(style_mel, np.float32))
    return dataclasses.replace(
        inputs, mel=style[None].expand(batch, *style.shape).contiguous(),
        mel_lengths=torch.full((batch,), style.shape[0], dtype=torch.int32))


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
                 prosody_ckpt: tp.Union[str, Path, ProsodyPredictionInterface, None] = None):
        """``model`` with its weights loaded, on its device and in its dtype;
        ``payload`` as a trainer stores it (``pipeline_info``). Raw text goes
        through ``text_parser``, else the G2P at ``g2p_ckpt``, else a
        ``g2p.pkl`` found beside ``ckpt_path``, else the char fallback.
        ``prosody_ckpt``: a prosody checkpoint directory (loaded on the model's
        device) or a built ``ProsodyPredictionInterface``."""
        self.model = model.eval()
        self.params = model.p
        p = next(model.parameters())
        self.device, self.dtype = p.device, p.dtype
        self.payload = dict(payload)
        info = payload["pipeline_info"]
        self._info = info
        self.pipeline = DataPipeline.from_info(info, ignored_handlers=AUDIO_HANDLERS)
        self._audio_pipeline: tp.Optional[DataPipeline] = None
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
        if prosody_ckpt is None or isinstance(prosody_ckpt, ProsodyPredictionInterface):
            self.prosody_interface = prosody_ckpt
        else:
            self.prosody_interface = ProsodyPredictionInterface(prosody_ckpt,
                                                                device=self.device)

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
        with dev:  # built where it runs: the initialisers it overwrites are cheap there
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

    def predict_prosody_by_text(self, words: tp.Sequence[str], ctx: TTSContext,
                                opts: tp.Optional[TTSOptions] = None) -> np.ndarray:
        """Each word's contour class from the prosody model, -1 where it
        predicts none; all -1 without a model or with
        ``opts.use_prosody_model`` off."""
        opts = opts or TTSOptions()
        if self.prosody_interface is None or not opts.use_prosody_model:
            return np.full(len(words), -1, np.int32)
        pred = self.prosody_interface.predict(list(words))
        return np.where(pred["has_contour"] > 0, pred["category"], -1).astype(np.int32)

    # -- embeddings ------------------------------------------------------------

    def _pipe_cfg(self, handler: str) -> dict:
        return dict(((self._info["config"].get("preproc") or {}).get("pipe_cfg") or {})
                    .get(handler) or {})

    def prepare_embeddings(self, ctx: TTSContext,
                           ref_audio: tp.Union[str, Path, AudioChunk, None] = None
                           ) -> TTSContext:
        """The context's speaker reference: with ``ref_audio`` (a path or an
        ``AudioChunk``, loaded at the pipeline's ``load_audio`` rate), its
        ``voice_biometrics`` embedding and its normalised log-mel at the
        pipeline's ``n_mels`` (the style mel); else, and for what the
        reference leaves unset, the catalog mean embedding of the speaker."""
        ref = ctx.prosody_reference
        ref.speaker_name = ref.speaker_name or ctx.speaker_name
        if ref_audio is not None:
            from speechflow_torch.data.processors.embeddings import voice_biometrics

            chunk = (ref_audio if isinstance(ref_audio, AudioChunk)
                     else AudioChunk(file_path=ref_audio))
            ds = TTSDataSample(audio_chunk=chunk)
            sr = self._pipe_cfg("load_audio").get("sample_rate", 24000)
            ds.audio_chunk.load(sr=sr)
            ds = voice_biometrics(ds)  # the handler's defaults, as the reference calls it
            ref.speaker_emb = ds.speaker_emb
            n_mels = self._pipe_cfg("linear_to_mel").get("n_mels", 80)
            if isinstance(n_mels, dict):
                n_mels = next(iter(n_mels.values()))
            mag = np_dsp.magnitude_np(ds.audio_chunk.waveform)
            ref.style_mel = np_dsp.normalize_mel_np(np_dsp.amp_to_db_np(
                np_dsp.linear_to_mel_np(mag, sr, int(n_mels))))
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
        """Word-by-word G2P, the pause plan, the ling/LM features and, for a
        model with ``use_prosody``, each phoneme's word's prosody class (-1 at
        pauses and service tokens)."""
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
        if self.params.use_prosody:
            classes = self.predict_prosody_by_text(words, ctx, opts)
            pros = np.full(len(phonemes), -1, np.int32)
            for i, w in enumerate(word_map):
                if w >= 0:
                    pros[i] = classes[w]
            if ds.n_tokens == len(pros) + 2:
                pros = np.concatenate([[-1], pros, [-1]]).astype(np.int32)
            ds.prosody = pros
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
        through the pipeline's handlers and collate, the context's style mel
        (if any) as every row's ``mel``; the inputs on the model's device,
        floats in its dtype (the SSML modifiers stay float32)."""
        samples = [self._build_ssml_sample(s, ctx) if "<prosody" in s
                   else self._build_plain_sample(s, ctx, opts) for s in sentences]
        inputs, _ = self.batch_processor(self.pipeline.datasample_to_batch(samples))
        if ctx.style_mel is not None and inputs.mel is None:
            inputs = _with_style_mel(inputs, ctx.style_mel, len(samples))
        return inputs.to(self.device, self.dtype)

    # -- inference ----------------------------------------------------------------

    @torch.inference_mode()
    def evaluate(self, inputs: TTSForwardInput, opts: tp.Optional[TTSOptions] = None,
                 noise: tp.Optional[torch.Tensor] = None,
                 generator: tp.Optional[torch.Generator] = None) -> TTSOutput:
        """The acoustic model's ``inference`` on prepared inputs, ``opts.t_out``
        frames. ``noise`` is the CFM's initial state (scaled by the
        temperature), else it is drawn from ``generator``."""
        opts = opts or TTSOptions()
        if noise is not None:
            noise = noise.to(self.device)
        return self.model.inference(inputs.to(self.device, self.dtype), t_out=opts.t_out,
                                    cfm_timesteps=opts.cfm_timesteps, noise=noise,
                                    generator=generator)

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

    def _audio_pipe(self) -> DataPipeline:
        """The full pipeline of ``pipeline_info``, audio handlers included."""
        if self._audio_pipeline is None:
            self._audio_pipeline = DataPipeline.from_info(self._info)
        return self._audio_pipeline

    @torch.inference_mode()
    def resynthesize(self, sega_path: tp.Union[str, Path],
                     ref_audio: tp.Union[str, Path, AudioChunk, None] = None,
                     opts: tp.Optional[TTSOptions] = None,
                     noise: tp.Optional[torch.Tensor] = None,
                     generator: tp.Optional[torch.Generator] = None) -> TTSOutput:
        """An annotated utterance (a TextGrid file) through the full pipeline
        and the model, over the utterance's mel frames. With ``ref_audio`` the
        speaker embedding and the style mel are the reference's (copy
        synthesis in another voice); ``t_out`` is taken from the source mel
        before the style mel replaces it. ``noise`` / ``generator`` as in
        ``evaluate``."""
        from speechflow_torch.data.parsers import TTSDSParser

        opts = opts or TTSOptions()
        pipe = self._audio_pipe()
        dataset = TTSDSParser().read_datasamples([str(sega_path)])
        if len(dataset) != 1:
            raise ValueError(f"could not parse {sega_path}")
        ds = dataset[0]
        ds.speaker_id = self.speaker2id.get(ds.speaker_name, 0)
        ds.lang_id = self.lang2id.get(ds.lang, 0)
        ctx = None
        if ref_audio is not None:
            ctx = self.prepare_embeddings(TTSContext(), ref_audio)
            ds.speaker_emb = ctx.speaker_emb
        inputs, _ = self.batch_processor(pipe.datasample_to_batch([ds]))
        t_out = int(inputs.mel.shape[1]) if inputs.mel is not None else opts.t_out
        if ctx is not None and inputs.mel is not None:
            inputs = _with_style_mel(inputs, ctx.style_mel, 1)
        return self.evaluate(inputs, dataclasses.replace(opts, t_out=t_out), noise, generator)
