"""XTTS-style model: a GPT over neural-codec tokens (counterpart of
``speechflow_tpu/models/tts/xtts.py``).

``XTTSModel.synthesize`` samples codec codes with the KV-cached
``GPTDecoder`` from text ids (plus a speaker and, with ``use_prompt``, a
reference-audio mel encoded by ``PromptEncoder``) and decodes them with the
codec. The teacher-forced call computes the GPT's cross-entropy on codes the
codec encodes from the target waveform; ``XTTSBatchProcessor`` and
``xtts_criterion`` put it under ``Trainer``. The constructor ends in
``flax_init_``, so a fresh model starts from flax's initialisers; ``boa_tok``
(N(0, 0.02)) and the codebooks (N(0, 1)) keep their own.

The codes are an argmin, so the loss reaches the codec through integers only
and its gradient is zero, ``freeze_codec`` or not, as in JAX (whose
``jax.grad`` returns zeros there; AdamW's decay still moves the codec). The
port encodes under ``no_grad``: the same codes, without the encoder's graph.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn as nn

from speechflow_torch.models.layers import Conv1d, flax_init_, layer_norm
from speechflow_torch.models.tts.ar_decoders import GPTDecoder
from speechflow_torch.models.tts.batch_processor import _tensor
from speechflow_torch.models.tts.common import TransformerBlock, gelu
from speechflow_torch.training.base_model import BaseModelParams

__all__ = ["XTTSParams", "XTTSModel", "PromptEncoder", "XTTSBatchProcessor",
           "xtts_criterion"]


@dataclasses.dataclass
class XTTSParams(BaseModelParams):
    n_symbols: int = 256
    n_speakers: int = 1
    dim: int = 512
    n_layers: int = 8
    n_heads: int = 8
    block_type: str = "attention"      # attention | retention
    speaker_emb_dim: int = 128
    codec: dict = dataclasses.field(default_factory=dict)
    freeze_codec: bool = True
    # audio-prompt (zero-shot voice cloning) conditioning
    use_prompt: bool = False
    prompt_dim: int = 80               # prompt mel bins
    prompt_layers: int = 2             # attention blocks of the prompt encoder
    prompt_downsample: int = 4         # stride over prompt frames
    prompt_max_frames: int = 0         # 0: the whole prompt


class PromptEncoder(nn.Module):
    """Prompt mel (B, T, n_mels) -> (B, ceil(T/ds), dim) frames and their
    lengths: a strided conv (kernel 2·ds, stride ds, XLA SAME), gelu, attention
    blocks of ``n_heads`` heads (4, as JAX's default: at the recipe's width
    1024 a head is 256 wide, which ``fused_attention`` serves), LayerNorm."""

    def __init__(self, n_mels: int, dim: int, n_layers: int = 2, n_heads: int = 4,
                 downsample: int = 4):
        super().__init__()
        self.down = Conv1d(n_mels, dim, 2 * downsample, stride=downsample)
        self.blocks = nn.ModuleList(TransformerBlock(dim, n_heads=n_heads)
                                    for _ in range(n_layers))
        self.norm = layer_norm(dim)
        self.downsample = downsample

    def forward(self, mel: torch.Tensor, lengths: tp.Optional[torch.Tensor] = None):
        h = gelu(self.down(mel))
        out_len = valid = None
        if lengths is not None:
            out_len = ((lengths.to(h.device) + self.downsample - 1)
                       // self.downsample).clamp(min=1).to(torch.int32)
            valid = torch.arange(h.shape[1], device=h.device)[None] < out_len[:, None]
        for blk in self.blocks:
            h = blk(h, valid)
        return self.norm(h), out_len


class XTTSModel(nn.Module):
    def __init__(self, params: XTTSParams):
        # imported here: models/codec/rvq.py imports this package's common.py, so a
        # module-level import would be circular when the codec is imported first
        from speechflow_torch.models.codec import CodecParams, NeuralCodec

        super().__init__()
        self.p = params
        self.codec = NeuralCodec(CodecParams.create(params.codec))
        self.n_codes = self.codec.p.codebook_size
        # +2: BOS and EOS in the GPT's audio vocabulary
        self.gpt = GPTDecoder(
            n_text_tokens=params.n_symbols, n_audio_tokens=self.n_codes + 2,
            dim=params.dim, n_layers=params.n_layers, n_heads=params.n_heads,
            block_type=params.block_type, use_prompt=params.use_prompt,
            cond_dim=params.speaker_emb_dim)
        self.speaker_emb = nn.Embedding(params.n_speakers, params.speaker_emb_dim)
        self.prompt_enc = (PromptEncoder(params.prompt_dim, params.dim,
                                         n_layers=params.prompt_layers,
                                         downsample=params.prompt_downsample)
                           if params.use_prompt else None)
        flax_init_(self)

    def _cond(self, speaker_id: tp.Optional[torch.Tensor]) -> tp.Optional[torch.Tensor]:
        if speaker_id is None:
            return None
        return self.speaker_emb(speaker_id.to(self.speaker_emb.weight.device).clamp(min=0))

    def _encode_prompt(self, prompt_mel: tp.Optional[torch.Tensor],
                       prompt_lengths: tp.Optional[torch.Tensor] = None):
        """(B, T, n_mels) prompt -> (emb, lengths) for the GPT, cut to
        ``prompt_max_frames`` first when that is set."""
        if prompt_mel is None or self.prompt_enc is None:
            return None, None
        cap = self.p.prompt_max_frames
        if cap and prompt_mel.shape[1] > cap:
            prompt_mel = prompt_mel[:, :cap]
            if prompt_lengths is not None:
                prompt_lengths = prompt_lengths.clamp(max=cap)
        return self.prompt_enc(prompt_mel, prompt_lengths)

    def forward(self, inputs: tp.Mapping[str, tp.Any]) -> tp.Dict[str, torch.Tensor]:
        """``inputs``: 'transcription', 'waveform', and optionally
        'waveform_lengths', 'speaker_id', 'prompt_mel', 'prompt_mel_lengths'.
        Returns the teacher-forced GPT cross-entropy, {'gpt_ce': loss}."""
        get = inputs.get if isinstance(inputs, tp.Mapping) else (
            lambda k, d=None: getattr(inputs, k, d))
        with torch.no_grad():  # integer codes: no gradient flows back through them
            codes = self.codec.encode(get("waveform"))[..., 0]  # the first quantizer stream
        lens = torch.full((codes.shape[0],), codes.shape[1], dtype=torch.int32,
                          device=codes.device)
        wl = get("waveform_lengths")
        if wl is not None:
            lens = (wl.to(codes.device) // self.codec.hop).clamp(min=1)
        p_emb, p_len = self._encode_prompt(get("prompt_mel"), get("prompt_mel_lengths"))
        loss = self.gpt.loss(get("transcription"), codes, lens, self._cond(get("speaker_id")),
                             prompt_emb=p_emb, prompt_lengths=p_len)
        return {"gpt_ce": loss}

    @torch.no_grad()
    def synthesize(self, text_ids: torch.Tensor, speaker_id: tp.Optional[torch.Tensor] = None,
                   max_tokens: int = 256, temperature: float = 0.8,
                   generator: tp.Optional[torch.Generator] = None,
                   prompt_mel: tp.Optional[torch.Tensor] = None,
                   prompt_mel_lengths: tp.Optional[torch.Tensor] = None,
                   gumbel: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """Text ids (B, T) -> waveform (B, max_tokens·hop). ``prompt_mel``
        (B, T, n_mels): a reference-audio mel for zero-shot voice cloning;
        ``gumbel``: given sampling noise (see ``GPTDecoder.generate``)."""
        p_emb, p_len = self._encode_prompt(prompt_mel, prompt_mel_lengths)
        codes = self.gpt.generate(text_ids, max_tokens=max_tokens, temperature=temperature,
                                  generator=generator, cond=self._cond(speaker_id),
                                  prompt_emb=p_emb, prompt_lengths=p_len, gumbel=gumbel)
        return self.codec.decode(codes.clamp(0, self.n_codes - 1)[..., None])


class XTTSBatchProcessor:
    """Collated TTS batch -> (inputs, {}): the text ids, the waveform with its
    lengths, the speaker ids and, from a ``TTSCollateWithPrompt`` batch, the
    prompt mel with its lengths, as CPU tensors (None where the batch has none)."""

    def __call__(self, c) -> tp.Tuple[tp.Dict[str, tp.Optional[torch.Tensor]], dict]:
        additional = getattr(c, "additional", None) or {}
        inputs = {k: _tensor(getattr(c, k, None)) for k in
                  ("transcription", "waveform", "waveform_lengths", "speaker_id")}
        for k in ("prompt_mel", "prompt_mel_lengths"):
            inputs[k] = _tensor(additional.get(k))
        return inputs, {}


def xtts_criterion() -> tp.Callable:
    """``XTTSModel`` returns its loss dict; the criterion passes it through."""

    def criterion(outputs, targets, step):
        return outputs

    return criterion
