"""Handlers (counterpart of ``speechflow_tpu/data/processors``): named
functions over a sample, found by the names a pipeline config lists.

Ported: the text path's (``text_to_transcription``, ``phonemize``,
``add_ling_feat``, ``add_lm_feat``, ``add_xpbert_feat``), the audio path's
(``data/processors/audio.py``, ``denoise`` among them), the spectral handlers
(``data/processors/spectral.py``), the alignment-derived ones
(``data/processors/tts.py``) and the model-based ones
(``data/processors/embeddings.py``); ``get_handler`` raises
``NotImplementedError`` for any other name.
"""

import typing as tp

__all__ = ["get_handler"]


def get_handler(name: str) -> tp.Callable:
    from speechflow_torch.data.processors import audio, embeddings, ling, spectral, tts
    from speechflow_torch.data.processors.text import phonemize, text_to_transcription

    handlers = {"text_to_transcription": text_to_transcription, "phonemize": phonemize,
                **{n: getattr(ling, n) for n in ("add_ling_feat", "add_lm_feat",
                                                 "add_xpbert_feat")},
                **{n: getattr(m, n) for m in (audio, spectral, tts) for n in m.__all__},
                **{n: getattr(embeddings, n) for n in ("voice_biometrics", "ssl_features",
                                                       "speech_quality", "codec_features")}}
    if name not in handlers:
        raise NotImplementedError(f"handler '{name}' is not ported; ported: {sorted(handlers)}")
    return handlers[name]
