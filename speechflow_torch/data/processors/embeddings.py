"""Model-based feature handlers (counterpart of
``speechflow_tpu/data/processors/embeddings.py``): speaker embeddings
(``voice_biometrics``), SSL features (``ssl_features``), speech quality
(``speech_quality``) and neural-codec features (``codec_features``).

Each handler takes its model from a process-wide hook (``set_*_model``), else
from a checkpoint in its config (``model_ckpt``, loaded once per path), else
computes JAX's deterministic fallback on the host: a spectral-statistics
embedding through a fixed projection, framed log-mel, signal statistics. The
fallbacks are the reference's semantics without a model, not a way around
the device: a hook built from a checkpoint runs on the GPU unless it was
asked for the CPU, and raises where there is no CUDA.

``make_ecapa_hook`` pads the waveform to a multiple of ``hop_len * 64`` before
the STFT, as JAX does to bound its jit shapes; the embedder's squeeze
averages over padded frames too, so the padding is part of the function and
is kept; ``make_cpc_hook`` (a CPC model) and ``make_codec_hook`` pad the same
way. ``make_hf_wav2vec2_hook`` (HF weights, not in the repository) raises.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from speechflow_torch.data.core.datasample import AudioDataSample
from speechflow_torch.data.processors import handler, np_dsp

__all__ = ["set_biometric_model", "set_ssl_model", "set_quality_model", "set_codec_model",
           "make_ecapa_hook", "make_codec_hook", "make_cpc_hook", "make_hf_wav2vec2_hook",
           "voice_biometrics", "ssl_features", "speech_quality", "codec_features"]

_MODELS: tp.Dict[str, tp.Callable] = {}


def set_biometric_model(fn: tp.Optional[tp.Callable[[np.ndarray, int], np.ndarray]]) -> None:
    """fn(waveform, sr) -> (emb_dim,) embedding (None clears the hook)."""
    _set("biometric", fn)


def set_ssl_model(fn: tp.Optional[tp.Callable[[np.ndarray, int], np.ndarray]]) -> None:
    """fn(waveform, sr) -> (T', D) features."""
    _set("ssl", fn)


def set_quality_model(fn: tp.Optional[tp.Callable[[np.ndarray, int], np.ndarray]]) -> None:
    """fn(waveform, sr) -> (5,) MOS dimensions."""
    _set("quality", fn)


def set_codec_model(encode: tp.Optional[tp.Callable[[np.ndarray, int], np.ndarray]]) -> None:
    """encode(waveform, sr) -> (T', n_q) int codes or (T', D) latents."""
    _set("codec", encode)


def _set(kind: str, fn: tp.Optional[tp.Callable]) -> None:
    if fn is None:
        _MODELS.pop(kind, None)
    else:
        _MODELS[kind] = fn


def _pad_to_multiple(wav: np.ndarray, multiple: int) -> tp.Tuple[np.ndarray, int]:
    """Zero-pad to a multiple of ``multiple``; returns (padded, original length)."""
    n = len(wav)
    m = ((n + multiple - 1) // multiple) * multiple
    return (np.pad(wav, (0, m - n)) if m != n else wav), n


def _fallback_embedding(wav: np.ndarray, sr: int, dim: int = 192) -> np.ndarray:
    """Deterministic spectral-statistics embedding: the mean, std and 0.9
    quantile of 64 log-mels through a fixed ``default_rng(12345)`` projection,
    L2-normalised."""
    mag = np_dsp.magnitude_np(wav, 1024, 256)
    mel = np_dsp.amp_to_db_np(np_dsp.linear_to_mel_np(mag, sr, 64))
    stats = np.concatenate([mel.mean(0), mel.std(0), np.quantile(mel, 0.9, 0)])
    rng = np.random.default_rng(12345)  # fixed projection
    proj = rng.normal(size=(len(stats), dim)).astype(np.float32) / np.sqrt(len(stats))
    emb = stats.astype(np.float32) @ proj
    return emb / max(np.linalg.norm(emb), 1e-9)


def make_ecapa_hook(ckpt_path: str, n_fft: int = 1024, hop_len: int = 256,
                    device: tp.Union[str, torch.device, None] = None) -> tp.Callable:
    """Waveform -> embedding hook of an ECAPA embedder saved with ``save_module``
    (either package's), on ``device`` (the GPU unless ``device="cpu"``): the
    waveform padded to a multiple of ``hop_len * 64``, its log-mel at the
    embedder's ``n_mels`` on the host, the embedder with the unpadded frames
    as its pooling length, the embedding L2-normalised again."""
    from speechflow_torch.models.biometric import ECAPAEmbedder, ECAPAParams
    from speechflow_torch.utils.state_io import load_module

    model, params = load_module(ECAPAEmbedder, ECAPAParams, ckpt_path, device=device)
    dev = next(model.parameters()).device

    def fn(wav: np.ndarray, sr: int) -> np.ndarray:
        n_valid = len(wav) // hop_len  # frames of real (unpadded) audio
        wav, _ = _pad_to_multiple(wav, hop_len * 64)
        mag = np_dsp.magnitude_np(wav, n_fft, hop_len)
        mel = np_dsp.amp_to_db_np(np_dsp.linear_to_mel_np(mag, sr, params.n_mels))
        lens = torch.tensor([min(max(n_valid, 1), mel.shape[0])], dtype=torch.int32,
                            device=dev)
        x = torch.from_numpy(np.ascontiguousarray(mel[None], np.float32)).to(dev)
        with torch.inference_mode():
            emb = model(x, lens)[0].float().cpu().numpy()
        return emb / max(np.linalg.norm(emb), 1e-9)

    fn.model = model
    return fn


def make_codec_hook(ckpt_path: str,
                    device: tp.Union[str, torch.device, None] = None) -> tp.Callable:
    """Waveform -> quantised latents (T', D) hook of a ``NeuralCodec`` saved with
    ``save_module``, on ``device`` (the GPU unless ``device="cpu"``): the
    waveform padded to a multiple of ``hop * 64``, the latents cut to
    ``max(len // hop, 1)`` frames."""
    from speechflow_torch.models.codec import CodecParams, NeuralCodec
    from speechflow_torch.utils.state_io import load_module

    model, _ = load_module(NeuralCodec, CodecParams, ckpt_path, device=device)
    dev = next(model.parameters()).device
    hop = model.hop

    def encode(wav: np.ndarray, sr: int) -> np.ndarray:
        padded, n = _pad_to_multiple(wav, hop * 64)
        x = torch.from_numpy(np.ascontiguousarray(padded[None], np.float32)).to(dev)
        with torch.inference_mode():
            q = model.rvq(model.encode_latent(x))[0][0].float().cpu().numpy()
        return q[: max(n // hop, 1)]

    encode.model = model
    return encode


def make_cpc_hook(ckpt_path: str,
                  device: tp.Union[str, torch.device, None] = None) -> tp.Callable:
    """Waveform -> (T', context_dim) CPC features hook of a ``CPCModel`` saved
    with ``save_module`` (either package's), on ``device`` (the GPU unless
    ``device="cpu"``): the waveform padded to a multiple of ``hop * 64``, the
    features cut to ``max(len // hop, 1)`` frames."""
    from speechflow_torch.models.ssl import CPCModel, CPCParams
    from speechflow_torch.utils.state_io import load_module

    model, _ = load_module(CPCModel, CPCParams, ckpt_path, device=device)
    dev = next(model.parameters()).device
    hop = model.hop

    def fn(wav: np.ndarray, sr: int) -> np.ndarray:
        padded, n = _pad_to_multiple(wav, hop * 64)
        x = torch.from_numpy(np.ascontiguousarray(padded[None], np.float32)).to(dev)
        with torch.inference_mode():
            f = model(x)[0].float().cpu().numpy()
        return f[: max(n // hop, 1)]

    fn.model = model
    return fn


def make_hf_wav2vec2_hook(model_name: str = "facebook/wav2vec2-base",
                          layer: int = -1) -> tp.Callable:
    raise NotImplementedError("HF wav2vec2 weights are not in the repository; the wav2vec2 "
                              "hook is not ported")


def _checkpoint_hook(kind: str, ckpt: tp.Optional[str],
                     factory: tp.Callable[[str], tp.Callable]) -> tp.Optional[tp.Callable]:
    """The model of a handler: a ``set_*_model`` hook wins, then the handler's
    ``model_ckpt`` (built once per path), else None."""
    fn = _MODELS.get(kind)
    if fn is not None:
        return fn
    if ckpt:
        key = f"{kind}@{ckpt}"
        if key not in _MODELS:
            _MODELS[key] = factory(ckpt)
        return _MODELS[key]
    return None


@handler(inputs={"audio_chunk"}, outputs={"speaker_emb"})
def voice_biometrics(ds: AudioDataSample, emb_dim: int = 192,
                     model_ckpt: tp.Optional[str] = None) -> AudioDataSample:
    wav, sr = ds.audio_chunk.waveform, ds.audio_chunk.sr
    fn = _checkpoint_hook("biometric", model_ckpt, make_ecapa_hook)
    ds.speaker_emb = (fn(wav, sr) if fn else
                      _fallback_embedding(wav, sr, emb_dim)).astype(np.float32)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"ssl_feat"})
def ssl_features(ds: AudioDataSample, hop_len: int = 256, dim: int = 256,
                 model_ckpt: tp.Optional[str] = None) -> AudioDataSample:
    wav, sr = ds.audio_chunk.waveform, ds.audio_chunk.sr
    fn = _checkpoint_hook("ssl", model_ckpt, make_cpc_hook)
    if fn is not None:
        ds.ssl_feat = np.asarray(fn(wav, sr), np.float32)
    else:  # framed log-mel context features at the SSL frame rate
        mag = np_dsp.magnitude_np(wav, 1024, hop_len)
        mel = np_dsp.amp_to_db_np(np_dsp.linear_to_mel_np(mag, sr, min(dim, 128)))
        ds.ssl_feat = mel.astype(np.float32)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"speech_quality_emb"})
def speech_quality(ds: AudioDataSample) -> AudioDataSample:
    wav, sr = ds.audio_chunk.waveform, ds.audio_chunk.sr
    fn = _MODELS.get("quality")
    if fn is not None:
        ds.speech_quality_emb = np.asarray(fn(wav, sr), np.float32)
    else:  # signal statistics in place of the 5 MOS dimensions
        rms = float(np.sqrt(np.mean(wav ** 2) + 1e-12))
        mag = np_dsp.magnitude_np(wav, 1024, 256)
        flat = float(np_dsp.spectral_flatness_np(mag).mean())
        peak = float(np.abs(wav).max())
        clip_frac = float(np.mean(np.abs(wav) > 0.98))
        ds.speech_quality_emb = np.asarray([rms, flat, peak, clip_frac, 1.0 - clip_frac],
                                           np.float32)
    return ds


@handler(inputs={"audio_chunk"}, outputs={"ac_feat"})
def codec_features(ds: AudioDataSample, hop_len: int = 512,
                   model_ckpt: tp.Optional[str] = None) -> AudioDataSample:
    wav, sr = ds.audio_chunk.waveform, ds.audio_chunk.sr
    fn = _checkpoint_hook("codec", model_ckpt, make_codec_hook)
    if fn is not None:
        ds.ac_feat = np.asarray(fn(wav, sr))
    else:
        mag = np_dsp.magnitude_np(wav, 1024, hop_len)
        ds.ac_feat = np_dsp.amp_to_db_np(np_dsp.linear_to_mel_np(mag, sr, 64))
    return ds
