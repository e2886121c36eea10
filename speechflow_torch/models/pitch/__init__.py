"""Trainable pitch tracker (counterpart of ``speechflow_tpu.models.pitch``)."""

from speechflow_torch.models.pitch.crepe import (
    CrepeF0,
    CrepeParams,
    crepe_f0,
    load_crepe,
    save_crepe,
    synth_pitch_batch,
    train_crepe,
)

__all__ = ["CrepeParams", "CrepeF0", "crepe_f0", "train_crepe", "synth_pitch_batch",
           "save_crepe", "load_crepe"]
