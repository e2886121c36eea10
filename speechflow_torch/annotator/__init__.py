"""Annotation tools (counterpart of ``speechflow_tpu.annotator``): transcription
(``asr``, ``cloud_asr``), text onto ASR timestamps (``text_alignment``), utterance
segmentation (``seg_generator``), the forced aligner's stages (``align``), corpus
layouts (``prepare_datasets``) and the 5-step ``runner``."""

from speechflow_torch.annotator.align import Aligner, AlignStage
from speechflow_torch.annotator.asr import ASRBase, FileASR, WhisperASR, run_audio_transcription
from speechflow_torch.annotator.cloud_asr import (
    ASRException,
    ASRRequestLimitException,
    CloudASR,
    GoogleSTTService,
    YandexSTTService,
    run_cloud_transcription,
)
from speechflow_torch.annotator.seg_generator import SegGenerator
from speechflow_torch.annotator.text_alignment import align_words, normalize_word

__all__ = ["ASRBase", "FileASR", "WhisperASR", "run_audio_transcription",
           "ASRException", "ASRRequestLimitException", "CloudASR",
           "GoogleSTTService", "YandexSTTService", "run_cloud_transcription",
           "align_words", "normalize_word", "SegGenerator", "Aligner", "AlignStage"]
