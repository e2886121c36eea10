"""Vocoder inference interface (counterpart of
``speechflow_tpu/interface/vocoder_interface.py``).

``synthesize(mel | TTSOutput) -> AudioChunk``; ``resynthesize`` runs
waveform -> features on the device -> waveform, a copy-synthesis check. An
NSF head takes its F0 from ``synthesize(..., f0=)`` or the TTS output's pitch
prediction, and in ``resynthesize`` from the host's YIN of the waveform. The BigVGAN-class head is folded by default, as the
JAX interface serves it.

``from_checkpoint(tree, payload)`` takes what
``training.saver.ExperimentSaver.load_checkpoint`` returns for a checkpoint of
either package (the port's, or the JAX trainer's orbax OCDBT one).
"""

from __future__ import annotations

import os
import typing as tp

import numpy as np
import torch

from speechflow_torch.convert import load_nnx_state
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.models.vocoder import Vocos, VocosParams
from speechflow_torch.models.vocoder.model import split_output
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.utils.device import resolve_device

__all__ = ["VocoderEvaluationInterface"]


def _generator(tree: tp.Mapping, payload: tp.Mapping, dev: torch.device,
               dtype: torch.dtype) -> Vocos:
    """The generator of a vocoder checkpoint's ``(tree, payload)`` (a GAN
    checkpoint's ``generator`` or a plain model; legacy layouts are migrated in
    place), its weights loaded, on ``dev`` in ``dtype``."""
    model_tree = ExperimentSaver.remap_legacy_keys(tree["model"])
    if "generator" in model_tree:  # the GAN trainer's layout
        model_tree = model_tree["generator"]
    with dev:  # built where it runs: the initialisers it overwrites are cheap there
        model = Vocos(VocosParams.create(payload["model_params"]))
    return load_nnx_state(model, model_tree).to(dev, dtype)


class VocoderEvaluationInterface:
    def __init__(self, model: tp.Optional[Vocos] = None, fold_inference: bool = True,
                 payload: tp.Optional[dict] = None,
                 ckpt_path: tp.Union[str, os.PathLike, None] = None,
                 device: tp.Union[str, torch.device, None] = None):
        """``model`` with its weights loaded, or the checkpoint at ``ckpt_path``
        (either package's, as JAX's interface takes it) on ``device`` (the GPU
        unless ``device="cpu"``); folding scatters the weights, so it comes after
        the load."""
        if model is None:
            if ckpt_path is None:
                raise ValueError("pass a model or a ckpt_path")
            tree, loaded = ExperimentSaver.load_checkpoint(ckpt_path)
            model, payload = _generator(tree, loaded, resolve_device(device), torch.float32), \
                dict(loaded)
        self.model = model.eval()
        self.params = model.params
        self.payload = payload or {}
        if fold_inference:
            self.model.fold_inference()  # a no-op for heads other than BigVGAN's

    @classmethod
    def from_checkpoint(cls, tree: tp.Mapping, payload: tp.Mapping,
                        fold_inference: bool = True,
                        device: tp.Union[str, torch.device, None] = None,
                        dtype: torch.dtype = torch.float32) -> "VocoderEvaluationInterface":
        """Rebuild the generator from ``(tree, payload)`` of a vocoder
        checkpoint on ``device`` (the GPU unless ``device="cpu"``) in ``dtype``."""
        return cls(_generator(tree, payload, resolve_device(device), dtype), fold_inference,
                   dict(payload))

    @property
    def sample_rate(self) -> int:
        return self.params.sample_rate

    def _tensor(self, x) -> torch.Tensor:
        """An array or tensor on the model's device, in its dtype."""
        p = next(self.model.parameters())
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
        return x.to(device=p.device, dtype=p.dtype)

    def _nsf_f0(self, mel_or_output, f0) -> tp.Optional[torch.Tensor]:
        """An NSF head's frame-level F0: ``f0`` as given, else a TTS output's
        token-level pitch prediction through its length-regulator attention."""
        if f0 is None:
            vp = getattr(mel_or_output, "variance_predictions", None) or {}
            attn = getattr(mel_or_output, "attention", None)
            if vp.get("aggregate_pitch") is not None and attn is not None:
                f0 = torch.einsum("btn,bn->bt", attn.float(), vp["aggregate_pitch"].float())
        if f0 is None:
            return None
        f0 = self._tensor(f0).float()
        return f0[None] if f0.ndim == 1 else f0

    @torch.inference_mode()
    def synthesize(self, mel_or_output, speaker_emb=None, f0=None,
                   sine_noise=None) -> AudioChunk:
        """A mel (T, n_mels) or (B, T, n_mels), or a ``TTSOutput`` (its
        postnet mel) -> an ``AudioChunk`` clipped to [-1, 1] ((B, N) data,
        or (N,) at B=1). An NSF head takes ``f0`` (frames, Hz), else the TTS
        output's pitch (zeros when neither is there), with ``speaker_emb`` as its
        style; ``sine_noise`` injects its source's draws."""
        mel = getattr(mel_or_output, "after_postnet_spectrogram", None)
        mel = self._tensor(mel_or_output if mel is None else mel)
        if mel.ndim == 2:
            mel = mel[None]
        cond = None if speaker_emb is None else self._tensor(speaker_emb)
        kwargs = {}
        if self.model.nsf_head:
            kwargs = dict(f0=self._nsf_f0(mel_or_output, f0), style=cond,
                          sine_noise=sine_noise)
        wav = self.model.from_features(mel, cond, **kwargs).float().cpu().numpy()
        wav = wav.reshape(-1) if wav.shape[0] == 1 else wav
        return AudioChunk(data=np.clip(wav, -1.0, 1.0), sr=self.sample_rate)

    @torch.inference_mode()
    def resynthesize(self, audio: AudioChunk, sine_noise=None) -> AudioChunk:
        """Waveform -> features on the device -> waveform, at the model's rate.
        An NSF head gets the host's YIN F0 of the waveform (80-880 Hz)."""
        wav = audio.load(sr=self.sample_rate).waveform
        p = next(self.model.parameters())
        x = torch.from_numpy(np.ascontiguousarray(wav, np.float32))[None].to(p.device)
        inputs = {"waveform": x}
        if self.model.nsf_head:
            from speechflow_torch.data.processors.np_dsp import yin_f0_np

            f0 = yin_f0_np(wav, self.sample_rate, self.params.hop_length, 2048, 80.0, 880.0,
                           0.2)
            inputs["pitch"] = torch.from_numpy(np.asarray(f0, np.float32))[None].to(p.device)
        out = self.model(inputs, sine_noise=sine_noise)
        wav = split_output(out)[0]
        return AudioChunk(data=np.clip(wav[0].float().cpu().numpy(), -1.0, 1.0),
                          sr=self.sample_rate)
