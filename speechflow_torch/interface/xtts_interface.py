"""XTTS inference interface (counterpart of
``speechflow_tpu/interface/xtts_interface.py``): checkpoint -> text -> codec
tokens -> waveform.

The interface rebuilds the text path from the checkpoint's payload (the data
pipeline of ``pipeline_info``, its alphabet and speaker map), tokenizes raw
text with the training alphabet (the char-level parser, as the JAX interface
does), samples codec tokens with the KV-cached GPT and decodes them with the
model's codec. A reference utterance (``ref_audio``) is turned into the mel
the training pipeline computes and prefixed to the GPT's context.

The constructor reads a checkpoint of either package's trainers
(``training.saver.ExperimentSaver``: the port's, or the JAX trainer's orbax
one) and builds the model on ``device``, the GPU unless
``device="cpu"``, in float32, as the JAX interface serves it.
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np
import torch

from speechflow_torch.convert import load_nnx_state
from speechflow_torch.data.core.components import DataPipeline
from speechflow_torch.data.processors import np_dsp
from speechflow_torch.data.processors.text import TTSTextProcessor
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.models.tts import XTTSModel, XTTSParams
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.utils.device import resolve_device

__all__ = ["XTTSEvaluationInterface"]

TOKEN_MULTIPLE = 16  # text ids are padded with id 0 to a multiple of this, and attended


class XTTSEvaluationInterface:
    def __init__(self, ckpt_path: tp.Union[str, Path],
                 device: tp.Union[str, torch.device, None] = None):
        """The model and text path of the port checkpoint at ``ckpt_path``."""
        self.device = resolve_device(device)
        tree, payload = ExperimentSaver.load_checkpoint(ckpt_path)
        self.payload = dict(payload)
        info = payload["pipeline_info"]
        self.pipeline = DataPipeline.from_info(info)
        self.alphabet = self.pipeline.alphabet
        self.text_processor = TTSTextProcessor(self.alphabet)
        self.params = XTTSParams.create(payload["model_params"])
        with self.device:  # built where it runs: the initialisers it overwrites are cheap there
            model = XTTSModel(self.params)
        self.model = load_nnx_state(model, tree["model"]).eval()
        spk = (info.get("singletons") or {}).get("SpeakerIDSetter", {})
        self.speaker2id: tp.Dict[str, int] = dict(spk.get("speaker2id", {}))
        self.sample_rate = int(self.params.codec.get("sample_rate", 24000))

    def get_speakers(self) -> tp.List[str]:
        return sorted(self.speaker2id)

    def prepare_text(self, text: str, lang: str = "EN") -> np.ndarray:
        return self.text_processor.encode_text(text, lang)

    def prompt_mel_from_audio(self, ref_audio: tp.Union[str, Path, AudioChunk]) -> np.ndarray:
        """Reference audio -> the normalized mel (T, n_mels) of the training
        pipeline's handlers, at the pipeline's sample rate. (The JAX interface
        computes it at the file's own rate: its ``waveform is None`` test never
        holds, so a file at another rate is not resampled.)"""
        chunk = ref_audio if isinstance(ref_audio, AudioChunk) else AudioChunk(file_path=ref_audio)
        pipe_cfg = ((self.payload["pipeline_info"].get("config") or {})
                    .get("preproc") or {}).get("pipe_cfg") or {}
        sr = (pipe_cfg.get("load_audio") or {}).get("sample_rate", self.sample_rate)
        n_mels = (pipe_cfg.get("linear_to_mel") or {}).get("n_mels", 80)
        if isinstance(n_mels, dict):
            n_mels = next(iter(n_mels.values()))
        wav = chunk.load(sr=sr).waveform
        mag = np_dsp.magnitude_np(wav)
        return np_dsp.normalize_mel_np(np_dsp.amp_to_db_np(
            np_dsp.linear_to_mel_np(mag, sr, int(n_mels)))).astype(np.float32)

    @torch.inference_mode()
    def synthesize(self, text: str, speaker: tp.Optional[str] = None, max_tokens: int = 512,
                   temperature: float = 0.8, seed: int = 0,
                   ref_audio: tp.Optional[tp.Union[str, Path, AudioChunk]] = None,
                   gumbel: tp.Optional[torch.Tensor] = None) -> AudioChunk:
        """Text -> an ``AudioChunk`` of ``max_tokens`` codec hops at the codec's
        rate. The sampling noise comes from a ``torch.Generator`` seeded with
        ``seed`` on the model's device (or is ``gumbel``, see
        ``GPTDecoder.generate``); ``ref_audio`` is the zero-shot voice prompt."""
        ids = self.prepare_text(text)
        ids = np.pad(ids, (0, (-len(ids)) % TOKEN_MULTIPLE))
        sid = None
        if speaker is not None:
            sid = torch.tensor([self.speaker2id.get(speaker, 0)], device=self.device)
        prompt_mel = prompt_lens = None
        if ref_audio is not None and self.params.use_prompt:
            mel = self.prompt_mel_from_audio(ref_audio)
            prompt_mel = torch.from_numpy(mel[None]).to(self.device)
            prompt_lens = torch.tensor([mel.shape[0]], dtype=torch.int32, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        wav = self.model.synthesize(
            torch.from_numpy(ids[None]).to(self.device), speaker_id=sid,
            max_tokens=max_tokens, temperature=temperature, generator=gen,
            prompt_mel=prompt_mel, prompt_mel_lengths=prompt_lens, gumbel=gumbel)
        return AudioChunk(data=wav[0].cpu().numpy(), sr=self.sample_rate)
