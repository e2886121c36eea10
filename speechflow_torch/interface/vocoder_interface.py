"""Vocoder inference interface (counterpart of
``speechflow_tpu/interface/vocoder_interface.py``).

``synthesize(mel | TTSOutput) -> AudioChunk``; ``resynthesize`` runs
waveform -> log-mel on the device (``MelFeatures``) -> waveform, a
copy-synthesis check. The BigVGAN-class head is folded by default, as the
JAX interface serves it.

``from_checkpoint(tree, payload)`` takes what
``training.saver.ExperimentSaver.load_checkpoint`` returns for a checkpoint of
either package (the port's, or the JAX trainer's orbax OCDBT one).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from speechflow_torch.convert import load_nnx_state
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.models.vocoder import Vocos, VocosParams
from speechflow_torch.training.saver import ExperimentSaver
from speechflow_torch.utils.device import resolve_device

__all__ = ["VocoderEvaluationInterface"]


class VocoderEvaluationInterface:
    def __init__(self, model: Vocos, fold_inference: bool = True,
                 payload: tp.Optional[dict] = None):
        """``model`` with its weights loaded; folding scatters them, so it
        comes after the load."""
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
        checkpoint (a GAN checkpoint's ``generator`` or a plain model; legacy
        layouts are migrated in place), on ``device`` (the GPU unless
        ``device="cpu"``) in ``dtype``."""
        dev = resolve_device(device)
        model_tree = ExperimentSaver.remap_legacy_keys(tree["model"])
        if "generator" in model_tree:  # the GAN trainer's layout
            model_tree = model_tree["generator"]
        model = load_nnx_state(Vocos(VocosParams.create(payload["model_params"])),
                               model_tree)
        return cls(model.to(dev, dtype), fold_inference, dict(payload))

    @property
    def sample_rate(self) -> int:
        return self.params.sample_rate

    def _tensor(self, x) -> torch.Tensor:
        """An array or tensor on the model's device, in its dtype."""
        p = next(self.model.parameters())
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
        return x.to(device=p.device, dtype=p.dtype)

    @torch.inference_mode()
    def synthesize(self, mel_or_output, speaker_emb=None) -> AudioChunk:
        """A mel (T, n_mels) or (B, T, n_mels), or a ``TTSOutput`` (its
        postnet mel) -> an ``AudioChunk`` clipped to [-1, 1] ((B, N) data,
        or (N,) at B=1)."""
        mel = getattr(mel_or_output, "after_postnet_spectrogram", None)
        mel = self._tensor(mel_or_output if mel is None else mel)
        if mel.ndim == 2:
            mel = mel[None]
        cond = None if speaker_emb is None else self._tensor(speaker_emb)
        wav = self.model.from_features(mel, cond).float().cpu().numpy()
        wav = wav.reshape(-1) if wav.shape[0] == 1 else wav
        return AudioChunk(data=np.clip(wav, -1.0, 1.0), sr=self.sample_rate)

    @torch.inference_mode()
    def resynthesize(self, audio: AudioChunk) -> AudioChunk:
        """Waveform -> log-mel on the device -> waveform, at the model's rate."""
        wav = audio.load(sr=self.sample_rate).waveform
        p = next(self.model.parameters())
        x = torch.from_numpy(np.ascontiguousarray(wav))[None].to(p.device)
        out = self.model({"waveform": x})[0].float().cpu().numpy()
        return AudioChunk(data=np.clip(out, -1.0, 1.0), sr=self.sample_rate)
