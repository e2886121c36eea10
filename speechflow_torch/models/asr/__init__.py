"""CTC phoneme recognizer (counterpart of ``speechflow_tpu.models.asr``)."""

from speechflow_torch.models.asr.ctc_model import (
    CTCRecognizer,
    CTCRecognizerParams,
    greedy_ctc_decode,
)

__all__ = ["CTCRecognizerParams", "CTCRecognizer", "greedy_ctc_decode"]
