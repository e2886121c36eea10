"""Neural audio codec (counterpart of ``speechflow_tpu.models.codec``)."""

from speechflow_torch.models.codec.rvq import CodecDecoder, CodecParams, NeuralCodec, ResidualVQ

__all__ = ["NeuralCodec", "CodecDecoder", "CodecParams", "ResidualVQ"]
