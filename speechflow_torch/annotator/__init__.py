"""Annotation tools (counterpart of ``speechflow_tpu.annotator``): the forced
aligner's stage, ``align.Aligner``, and the CTC recognizer's transcription,
``asr.CTCPhonemeASR``."""
