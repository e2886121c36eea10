"""The data pipeline rebuilt from a checkpoint's payload (counterpart of
``DataPipeline.from_info`` in ``speechflow_tpu/data/core/components.py``).

``from_info(payload["pipeline_info"], ignored_handlers)`` takes the plain
dict a trainer stores (the resolved data config, the alphabet and each
singleton handler's state) and builds the handler chain of ``preproc.pipe``
and the collate of ``collate``. Handlers in ``ignored_handlers`` are left
out; any other handler that is not ported raises ``NotImplementedError``
with its name. Singletons stay as their state dicts
(``pipeline.singletons[name]``): the eval interface reads the speaker and
language maps from them. Inference runs one chain, so the per-subset copies
the JAX pipeline builds for training are not made; the dataset, parser and
sampler sections are for training and are not read.
"""

from __future__ import annotations

import inspect
import logging
import typing as tp

from speechflow_torch.data.collate import COLLATES
from speechflow_torch.data.processors import get_handler
from speechflow_torch.data.processors.text import Alphabet, TTSTextProcessor

__all__ = ["DataPipeline"]

LOGGER = logging.getLogger("speechflow_torch")


def _known_kwargs(fn: tp.Callable, params: dict, what: str) -> dict:
    """``params`` that ``fn`` takes; the others are dropped with a warning."""
    names = set(inspect.signature(fn).parameters)
    dropped = sorted(set(params) - names)
    if dropped:
        LOGGER.warning("%s: ignoring unknown parameters %s", what, dropped)
    return {k: v for k, v in params.items() if k in names}


class DataPipeline:
    """The handler chain and collate of a payload's data config."""

    def __init__(self, info: tp.Mapping, ignored_handlers: tp.Iterable[str] = ()):
        cfg = info["config"]
        self.alphabet = Alphabet.from_dict(info["alphabet"]) if info.get("alphabet") else None
        self.singletons: tp.Dict[str, dict] = dict(info.get("singletons") or {})
        ignored_handlers = set(ignored_handlers)

        collate_cfg = dict(cfg.get("collate") or {})
        ctype = collate_cfg.pop("type", "none")
        if ctype not in COLLATES:
            raise NotImplementedError(f"collate '{ctype}' is not ported")
        self.collate_fn = COLLATES[ctype](**_known_kwargs(COLLATES[ctype], collate_cfg, ctype))

        preproc = cfg.get("preproc") or {}
        pipe_cfg = preproc.get("pipe_cfg") or {}
        # stage-2 aligner data configs turn the service tokens off
        service = bool((pipe_cfg.get("text_to_transcription") or {}).get(
            "add_service_tokens", True))
        self.text_processor = (TTSTextProcessor(self.alphabet, add_service_tokens=service)
                               if self.alphabet is not None else None)
        self.preproc_fns: tp.List[tp.Callable] = []
        self.handler_names: tp.List[str] = []
        for name in preproc.get("pipe") or []:
            if name in ignored_handlers:
                continue
            fn = get_handler(name)
            params = dict(pipe_cfg.get(name) or {})
            if name == "text_to_transcription":
                params.pop("add_service_tokens", None)
                params["processor"] = self.text_processor
            params = _known_kwargs(fn, params, name)
            self.preproc_fns.append(lambda ds, fn=fn, params=params: fn(ds, **params))
            self.handler_names.append(name)

    @staticmethod
    def from_info(info: tp.Mapping,
                  ignored_handlers: tp.Optional[tp.Iterable[str]] = None) -> "DataPipeline":
        """Rebuild a pipeline from a ``get_info()`` payload."""
        return DataPipeline(info, ignored_handlers or ())

    def datasample_to_batch(self, samples: tp.Sequence) -> tp.Any:
        """Every handler over every sample, then the collate. A failing
        sample raises: an inference request is never cut short silently."""
        processed = []
        for ds in samples:
            for fn in self.preproc_fns:
                ds = fn(ds)
            processed.append(ds)
        return self.collate_fn(processed)
