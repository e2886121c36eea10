"""Handlers (counterpart of ``speechflow_tpu/data/processors``): named
functions over a sample, found by the names a pipeline config lists, each
declared with the fields it reads and writes (``handler``, over
``data.core.registry.PipeRegistry``).

``get_handler`` resolves every name of the JAX package's registry: the audio,
spectral, text, linguistic, alignment-derived, model-based, contour (``signal1d``),
LPC, SSML and augmentation handlers. Unlike the JAX package, whose
``get_handler`` imports neither ``lpc`` nor ``ssml`` (so ``lpc`` and
``apply_ssml_modifiers`` raise ``KeyError`` in a fresh process there), it imports
every handler module before it looks a name up.
"""

import typing as tp

__all__ = ["HANDLERS", "handler", "get_handler"]

HANDLERS: tp.Dict[str, tp.Callable] = {}


def handler(inputs: tp.Optional[set] = None, outputs: tp.Optional[set] = None,
            optional: tp.Optional[set] = None):
    """Register the decorated function under its name with its contract."""
    from speechflow_torch.data.core.registry import PipeRegistry

    def deco(fn):
        fn = PipeRegistry.registry(inputs=inputs, outputs=outputs, optional=optional)(fn)
        HANDLERS[fn.__name__] = fn
        return fn

    return deco


def get_handler(name: str) -> tp.Callable:
    from speechflow_torch.data.processors import (  # noqa: F401
        audio, augment, embeddings, ling, lpc, signal1d, spectral, ssml, text, tts)

    if name not in HANDLERS:
        raise KeyError(f"unknown handler '{name}'; known: {sorted(HANDLERS)}")
    return HANDLERS[name]
