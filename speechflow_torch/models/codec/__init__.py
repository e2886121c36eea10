"""Neural audio codec (counterpart of ``speechflow_tpu.models.codec``)."""

from speechflow_torch.models.codec.rvq import (
    CodecDecoder,
    CodecParams,
    NeuralCodec,
    ResidualVQ,
    codec_criterion,
)

__all__ = ["NeuralCodec", "CodecDecoder", "CodecParams", "ResidualVQ", "codec_criterion"]
