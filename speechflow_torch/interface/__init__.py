"""Inference interfaces of the port: the TTS, vocoder and XTTS eval interfaces."""

from speechflow_torch.interface.tts_interface import TTSEvaluationInterface, TTSOptions
from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
from speechflow_torch.interface.xtts_interface import XTTSEvaluationInterface

__all__ = ["TTSEvaluationInterface", "TTSOptions", "VocoderEvaluationInterface",
           "XTTSEvaluationInterface"]
