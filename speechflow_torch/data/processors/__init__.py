"""Handlers (counterpart of ``speechflow_tpu/data/processors``): named
functions over a sample, found by the names a pipeline config lists.

Ported: the text path's (``text_to_transcription``, ``add_xpbert_feat``) and
the vocoder's audio path's (``data/processors/audio.py``); ``get_handler``
raises ``NotImplementedError`` for any other name.
"""

import typing as tp

__all__ = ["get_handler"]


def get_handler(name: str) -> tp.Callable:
    from speechflow_torch.data.processors import audio
    from speechflow_torch.data.processors.ling import add_xpbert_feat
    from speechflow_torch.data.processors.text import text_to_transcription

    handlers = {"text_to_transcription": text_to_transcription,
                "add_xpbert_feat": add_xpbert_feat,
                **{n: getattr(audio, n) for n in audio.__all__}}
    if name not in handlers:
        raise NotImplementedError(f"handler '{name}' is not ported; ported: {sorted(handlers)}")
    return handlers[name]
