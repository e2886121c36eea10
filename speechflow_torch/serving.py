"""The text -> waveform serving programs on the port.

- ``build_flagship``: the counterpart of the ``e2e`` program of
  ``bench.build_flagship_stages``: the acoustic model of
  ``configs/tts_model.yml`` (encoder and CFM-DiT decoder, 768 wide, 6
  layers, 6 heads; 30 Euler steps with batched CFG; ling/LM/XPBERT features;
  two languages; gate) and the BigVGAN vocoder of
  ``configs/vocoder_bigvgan.yml`` (Vocos backbone, 512 wide, 8 layers;
  ``snake_upsample`` head, rates 4·4·2·2·2·2, 1536 channels, MRF kernels
  3/7/11), its head folded as the bench folds it (the unfolded head, same
  weights, stays reachable as ``vm.head.inner``).
- ``build_toy``: the toy program of ``bench.build_toy``: a CFM acoustic model
  256 wide (4 encoder and 4 decoder layers, 4 heads, no CFG) and a Vocos
  vocoder 512 wide, 8 layers, with the ISTFT head.

``synthesize`` serves either: the acoustic model's postnet mel goes to
``vm.from_features``. ``flagship_payload`` makes the checkpoint payload a
trainer of the flagship would store (model params, and the pipeline info of
``configs/tts_data_24khz.yml`` with a seeded speaker catalog), from which
``interface.tts_interface.TTSEvaluationInterface`` rebuilds the text path. The
programs are built from presets, not files: the configs' model sections
transcribed field for field, with the bench's literals (CPU tests hold them
equal to the YAML files and to ``bench.py``); the training scripts read the
YAML files themselves (``io.config``).
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
import torch.nn as nn

from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams, TTSForwardInput
from speechflow_torch.models.vocoder import Vocos, VocosParams
from speechflow_torch.utils.device import resolve_device

__all__ = ["TTS_MODEL_PRESETS", "VOCODER_BIGVGAN_PRESETS", "VOCODER_MODEL_PRESETS",
           "FLAGSHIP_OVERRIDES", "TOY_TTS_PARAMS", "TOY_VOCODER_PARAMS", "flagship_params",
           "init_random_", "build_flagship", "build_toy", "synthesize", "bench_inputs",
           "TTS_DATA_CONFIG", "flagship_payload"]

_VARIANCES = [{"name": "aggregate_pitch"}, {"name": "aggregate_energy"},
              {"name": "durations"}]

# configs/tts_model.yml, section "model", per value_select
TTS_MODEL_PRESETS: tp.Dict[str, dict] = {
    "default": {
        "token_emb_dim": 256, "encoder_type": "transformer", "encoder_dim": 768,
        "encoder_layers": 6, "encoder_heads": 6, "decoder_type": "cfm",
        "decoder_dim": 768, "decoder_layers": 6, "decoder_heads": 6,
        "cfm_n_timesteps": 30, "speaker_emb_dim": 256, "postnet_dim": 256,
        "postnet_layers": 3, "max_output_length": 4096, "use_gate": True,
        "use_ling_feat": True, "use_lm_feat": True, "use_xpbert_feat": True,
        "ling_feat_dim": 56, "lm_feat_dim": 32, "xpbert_feat_dim": 32,
        "dropout": 0.1, "variances": _VARIANCES,
    },
    "debug": {
        "token_emb_dim": 64, "encoder_type": "transformer", "encoder_dim": 64,
        "encoder_layers": 2, "encoder_heads": 4, "decoder_type": "wrapper",
        "decoder_dim": 64, "decoder_layers": 2, "decoder_heads": 4,
        "cfm_n_timesteps": 30, "speaker_emb_dim": 32, "postnet_dim": 64,
        "postnet_layers": 3, "max_output_length": 1024, "use_gate": True,
        "use_ling_feat": True, "use_lm_feat": True, "use_xpbert_feat": True,
        "ling_feat_dim": 56, "lm_feat_dim": 32, "xpbert_feat_dim": 32,
        "dropout": 0.1, "variances": _VARIANCES,
    },
}

# configs/vocoder_bigvgan.yml, section "model", per value_select
VOCODER_BIGVGAN_PRESETS: tp.Dict[str, dict] = {
    "default": {
        "sample_rate": 24000, "n_fft": 1024, "hop_length": 256, "n_mels": 100,
        "feature_extractor": "mel", "backbone": "vocos", "head": "snake_upsample",
        "upsample_rates": [4, 4, 2, 2, 2, 2], "upsample_channels": 1536,
        "resblock_kernel_sizes": [3, 7, 11], "dim": 512, "n_layers": 8,
    },
    "debug": {
        "sample_rate": 24000, "n_fft": 1024, "hop_length": 256, "n_mels": 80,
        "feature_extractor": "mel", "backbone": "vocos", "head": "snake_upsample",
        "upsample_rates": [8, 8, 2, 2], "upsample_channels": 16,
        "resblock_kernel_sizes": [3], "dim": 64, "n_layers": 2,
    },
}

# configs/vocoder_model.yml, section "model", per value_select (Vocos, ISTFT head)
VOCODER_MODEL_PRESETS: tp.Dict[str, dict] = {
    "default": {
        "sample_rate": 24000, "n_fft": 1024, "hop_length": 256, "n_mels": 100,
        "feature_extractor": "mel", "backbone": "vocos", "head": "istft", "dim": 512,
        "n_layers": 8,
    },
    "debug": {
        "sample_rate": 24000, "n_fft": 1024, "hop_length": 256, "n_mels": 80,
        "feature_extractor": "mel", "backbone": "vocos", "head": "istft", "dim": 64,
        "n_layers": 2,
    },
}

# configs/tts_data_24khz.yml (default), the sections a pipeline rebuilt for inference reads
TTS_DATA_CONFIG: dict = {
    "preproc": {
        "pipe": ["load_audio", "volume_normalize", "multiple_audio", "magnitude",
                 "linear_to_mel", "amp_to_db", "normalize_mel", "energy", "pitch",
                 "add_pauses_from_timestamps", "text_to_transcription", "add_ling_feat",
                 "add_lm_feat", "add_xpbert_feat", "calc_durations", "aggregate_pitch",
                 "aggregate_energy", "gate_target"],
        "pipe_cfg": {"load_audio": {"sample_rate": 24000}, "multiple_audio": {"hop": 256},
                     "magnitude": {"n_fft": 1024, "hop_len": 256},
                     "linear_to_mel": {"n_mels": 100},
                     "pitch": {"f0_min": 80.0, "f0_max": 880.0}},
    },
    "collate": {"type": "TTSCollate", "token_multiple": 16, "frame_multiple": 64,
                "sample_multiple": 256},
    "singleton_handlers": ["SpeakerIDSetter", "StatisticsRange", "DatasetStatistics",
                           "PhonemeStatistics"],
}

T_FRAMES = 1024  # bench.T_FRAMES: 1024 frames * 256 hop / 24 kHz = 10.92 s
N_TOKENS = 128   # bench.N_TOKENS
FRAMES_PER_TOKEN = T_FRAMES / N_TOKENS  # the bench's utterances: 128 tokens in 1024 frames

# bench.build_flagship_stages' overrides (CFG on: doubled-batch estimator)
FLAGSHIP_OVERRIDES = {
    "tts": dict(n_symbols=100, n_speakers=8, n_langs=2, n_mels=100,
                max_output_length=T_FRAMES, dropout=0.0, cfm_cfg_scale=1.0),
    "vocoder": dict(feature_extractor="audio", input_feature="mel", n_mels=100),
}


# bench.build_toy's literals (CFM_STEPS = 30, T_FRAMES = 1024, HOP = 256, SR = 24000)
TOY_TTS_PARAMS = dict(
    n_symbols=100, n_speakers=8, n_mels=100, token_emb_dim=256, encoder_dim=256,
    encoder_layers=4, decoder_type="cfm", decoder_dim=256, decoder_layers=4,
    cfm_n_timesteps=30, speaker_emb_dim=128, postnet_dim=256, max_output_length=T_FRAMES,
    dropout=0.0,
)
TOY_VOCODER_PARAMS = dict(
    feature_extractor="audio", input_feature="mel", n_mels=100, backbone="vocos", dim=512,
    n_layers=8, head="istft", n_fft=1024, hop_length=256, sample_rate=24000,
)


def flagship_params(value_select: str = "default"
                    ) -> tp.Tuple[ParallelTTSParams, VocosParams]:
    tts = dict(TTS_MODEL_PRESETS[value_select], **FLAGSHIP_OVERRIDES["tts"])
    voc = dict(VOCODER_BIGVGAN_PRESETS[value_select], **FLAGSHIP_OVERRIDES["vocoder"])
    return ParallelTTSParams.create(tts), VocosParams.create(voc)


def flagship_payload(symbols: tp.Sequence[str]) -> dict:
    """The payload a trainer of the flagship stores beside its weights
    (``model_params``, ``pipeline_info``): the data config's pipeline
    sections, an alphabet of ``symbols`` plus the service tokens, and the
    singleton states of a catalog of ``n_speakers`` speakers (``speaker_<i>``,
    i + 1 hours of audio each) in EN and RU."""
    import dataclasses

    from speechflow_torch.data.processors.text import Alphabet

    tts, _ = flagship_params()
    alphabet = Alphabet(symbols)
    if len(alphabet) > tts.n_symbols:
        raise ValueError(f"{len(alphabet)} symbols > the model's n_symbols {tts.n_symbols}")
    speakers = [f"speaker_{i}" for i in range(tts.n_speakers)]
    info = {
        "config": TTS_DATA_CONFIG,
        "subsets": ["train", "test"],
        "alphabet": alphabet.to_dict(),
        "singletons": {
            "SpeakerIDSetter": {"speaker2id": {s: i for i, s in enumerate(speakers)},
                                "lang2id": {"EN": 0, "RU": 1}},
            "StatisticsRange": {"ranges": {}},
            "DatasetStatistics": {"speaker_durations": {
                s: 3600.0 * (i + 1) for i, s in enumerate(speakers)}},
            "PhonemeStatistics": {"counts": {s: 1 for s in alphabet.symbols[5:]}},
        },
    }
    return {"model_params": dataclasses.asdict(tts), "pipeline_info": info}


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: every matrix or kernel uniform in
    ±1/sqrt(fan_in), every bias zero; other vectors (norm scales, snake
    parameters, layer scales) keep their constructed constants. The draws are
    ``generator``'s, on its device, wherever the module lies."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                fan_in = p.shape[0] if isinstance(module.get_submodule(
                    name.rpartition(".")[0]), nn.Embedding) else math.prod(p.shape[1:])
                bound = 1.0 / math.sqrt(fan_in)
                p.copy_(torch.rand(p.shape, generator=generator, device=generator.device)
                        * 2 * bound - bound)
            elif name.endswith("bias"):
                p.zero_()
    return module


def _random_models(tts_p: ParallelTTSParams, voc_p: VocosParams, seed: int
                   ) -> tp.Tuple[ParallelTTSModel, Vocos]:
    """Both models with random weights from one seeded ``torch.Generator`` (on
    the CPU, float32; the models on torch's default device). The duration predictor's output bias is set to
    log(1 + FRAMES_PER_TOKEN), so that random weights predict utterances of a
    realistic length. The vocoder is folded for inference after the weights
    are drawn (``Vocos.fold_inference``: a BigVGAN head is folded, scattered in
    float32 before any cast; an ISTFT head is left as it is)."""
    gen = torch.Generator().manual_seed(seed)
    am = init_random_(ParallelTTSModel(tts_p), gen)
    vm = init_random_(Vocos(voc_p), gen)
    with torch.no_grad():
        am.variance_adaptor.predictors["durations"].out.bias.fill_(
            math.log1p(FRAMES_PER_TOKEN))
    vm.fold_inference()
    return am, vm


def build_flagship(value_select: str = "default",
                   device: tp.Union[str, torch.device, None] = None,
                   dtype: torch.dtype = torch.bfloat16, seed: int = 0
                   ) -> tp.Tuple[ParallelTTSModel, Vocos]:
    """The flagship acoustic model and vocoder with seeded random weights, in
    eval mode, on ``device`` (the GPU unless ``device="cpu"``) in ``dtype``.
    The vocoder's head is folded, as the bench serves it; ``vm.head.inner`` is
    the unfolded head with the same weights."""
    dev = resolve_device(device)
    with dev:  # built where they run (their initialisers are overwritten, seconds on a CPU)
        am, vm = _random_models(*flagship_params(value_select), seed)
    return am.to(dev, dtype).eval(), vm.to(dev, dtype).eval()


def build_toy(device: tp.Union[str, torch.device, None] = None,
              dtype: torch.dtype = torch.bfloat16, seed: int = 0
              ) -> tp.Tuple[ParallelTTSModel, Vocos]:
    """The toy acoustic model and ISTFT vocoder of ``bench.build_toy``
    (``TOY_TTS_PARAMS``, ``TOY_VOCODER_PARAMS``) with seeded random weights,
    in eval mode, on ``device`` (the GPU unless ``device="cpu"``) in ``dtype``."""
    dev = resolve_device(device)
    with dev:
        am, vm = _random_models(ParallelTTSParams.create(TOY_TTS_PARAMS),
                                VocosParams.create(TOY_VOCODER_PARAMS), seed)
    return am.to(dev, dtype).eval(), vm.to(dev, dtype).eval()


@torch.inference_mode()
def synthesize(am: ParallelTTSModel, vm: Vocos, inputs: TTSForwardInput,
               t_out: int = T_FRAMES, noise: tp.Optional[torch.Tensor] = None,
               generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
    """Tokens and features -> waveform (B, (t_out-1)·hop):
    ``am.inference(...).spectrogram[-1]`` then ``vm.from_features(mel)``. Inputs are
    moved to the models' device; float inputs take the models' dtype."""
    p = next(am.parameters())
    inputs = inputs.to(p.device, p.dtype)
    if noise is not None:
        noise = noise.to(p.device)
    mel = am.inference(inputs, t_out=t_out, noise=noise, generator=generator).spectrogram[-1]
    return vm.from_features(mel)


def bench_inputs(rng: np.random.Generator, batch: int = 32, n_tokens: int = N_TOKENS,
                 t_frames: int = T_FRAMES, features: bool = True) -> TTSForwardInput:
    """Request batch made as ``bench._tts_inputs(flagship=features)`` makes it
    (CPU tensors): tokens, speakers, language 0, lognormal teacher durations
    filling ``t_frames`` (read only when teacher-forced) and, for the
    flagship, the ling/LM/XPBERT features."""
    tts = FLAGSHIP_OVERRIDES["tts"]
    raw = rng.lognormal(mean=1.8, sigma=0.5, size=(batch, n_tokens))
    durs = np.maximum(np.round(raw / raw.sum(-1, keepdims=True) * t_frames), 1.0)
    durs[:, -1] = np.maximum(durs[:, -1] + (t_frames - durs.sum(-1)), 1.0)
    feats = {}
    if features:  # drawn in the bench's order
        feats = dict(
            ling_feat=torch.from_numpy(rng.uniform(0, 1, (batch, n_tokens, 56))).float(),
            lm_feat=torch.from_numpy(rng.normal(size=(batch, n_tokens, 32))).float(),
            xpbert_feat=torch.from_numpy(rng.normal(size=(batch, n_tokens, 32))).float(),
        )
    return TTSForwardInput(
        transcription=torch.from_numpy(rng.integers(1, tts["n_symbols"], (batch, n_tokens))),
        transcription_lengths=torch.full((batch,), n_tokens, dtype=torch.int32),
        speaker_id=torch.from_numpy(rng.integers(0, tts["n_speakers"], (batch,))),
        lang_id=torch.zeros((batch,), dtype=torch.int64),
        durations=torch.from_numpy(durs.astype(np.float32)),
        **feats,
    )
