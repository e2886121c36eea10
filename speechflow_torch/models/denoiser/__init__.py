"""Waveform denoiser (counterpart of ``speechflow_tpu.models.denoiser``)."""

from speechflow_torch.models.denoiser.demucs import (
    WaveDenoiser,
    WaveDenoiserParams,
    denoiser_criterion,
)

__all__ = ["WaveDenoiserParams", "WaveDenoiser", "denoiser_criterion"]
