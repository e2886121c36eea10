"""Data pipelines (counterpart of ``DataPipeline`` in
``speechflow_tpu/data/core/components.py``).

Two ways in:

- ``from_info(payload["pipeline_info"], ignored_handlers)`` rebuilds the
  handler chain of ``preproc.pipe`` and the collate from the plain dict a
  trainer stores (the resolved data config, the alphabet and each singleton
  handler's state), for inference. Handlers in ``ignored_handlers`` are left
  out; a name no handler has raises ``KeyError`` with it. Singletons stay as
  their state dicts
  (``pipeline.singletons[name]``).
- ``from_config(data_config)`` builds the training pipeline from a data
  config (the sections of ``configs/vocoder_data_24khz.yml``): the files of
  ``dirs.data_root`` with ``file_search.ext``, split by
  ``dataset.split_ratio`` (seeded), cut to ``max_num_samples``, parsed
  (``parser.type``), the singleton handlers fitted on the first subset and
  applied to every subset, and a sampler per subset (``sampler``).
  ``get_info()`` is what a checkpoint carries; ``sample_batch`` draws and
  collates one batch in this process; ``loader`` serves batches from PyTorch
  DataLoader worker processes (``n_workers``, ``prefetch_factor``), the one-host
  counterpart of the JAX data server.

A ``processor.dump`` section (``dump_path``, ``handlers``, ``full_dump``,
``update_handlers``, ...) gives the training batches the per-sample feature
cache of ``data/core/processor.py``, keyed by each handler's name and its
config parameters as the JAX package keys them. A handler with a ``ranges``
parameter (``normalize``) gets the ``StatisticsRange`` singleton.

In training a sample whose handlers raise (any exception) is dropped with a
warning (and recorded in the cache's ``skip_samples.txt``) by
``data/core/processor.py``'s ``DataProcessor``, as the JAX data processor drops
it; ``datasample_to_batch`` (inference) raises and never reads the cache.
"""

from __future__ import annotations

import collections
import functools
import importlib
import inspect
import logging
import os
import typing as tp

import torch

from speechflow_torch.concurrency.context import adopt_environment, worker_context

from speechflow_torch.data.collate import COLLATES
from speechflow_torch.data.core.processor import DataProcessor, DumpProcessor
from speechflow_torch.data.parsers import PARSERS
from speechflow_torch.data.processors import get_handler
from speechflow_torch.data.processors.singletons import SINGLETON_HANDLERS, StatisticsRange
from speechflow_torch.data.processors.text import Alphabet, TTSTextProcessor
from speechflow_torch.data.samplers import SAMPLERS
from speechflow_torch.io.flist import construct_file_list, split_file_list

__all__ = ["DataPipeline", "AudioLoader"]

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
        preproc = cfg.get("preproc") or {}
        for module in preproc.get("imports") or []:  # modules that register handlers, collates
            importlib.import_module(module)
        self.alphabet = Alphabet.from_dict(info["alphabet"]) if info.get("alphabet") else None
        self.singletons: tp.Dict[str, dict] = dict(info.get("singletons") or {})
        ignored_handlers = set(ignored_handlers)

        collate_cfg = dict(cfg.get("collate") or {})
        ctype = collate_cfg.pop("type", "none")
        if ctype not in COLLATES:
            raise NotImplementedError(f"collate '{ctype}' is not ported")
        self.collate_fn = COLLATES[ctype](**_known_kwargs(COLLATES[ctype], collate_cfg, ctype))

        pipe_cfg = preproc.get("pipe_cfg") or {}
        # stage-2 aligner data configs turn the service tokens off
        service = bool((pipe_cfg.get("text_to_transcription") or {}).get(
            "add_service_tokens", True))
        self.text_processor = (TTSTextProcessor(self.alphabet, add_service_tokens=service)
                               if self.alphabet is not None else None)
        ranges = None
        if "StatisticsRange" in self.singletons:
            ranges = StatisticsRange()
            ranges.load_state_dict(self.singletons["StatisticsRange"])
        self.preproc_fns: tp.List[tp.Callable] = []
        self.handler_names: tp.List[str] = []
        #: each handler's config parameters, which key its cached fields
        self.handler_params: tp.Dict[str, dict] = {}
        for name in preproc.get("pipe") or []:
            if name in ignored_handlers:
                continue
            fn = get_handler(name)
            params = dict(pipe_cfg.get(name) or {})
            if name == "text_to_transcription":
                params.pop("add_service_tokens", None)
                params["processor"] = self.text_processor
            if ranges is not None and "ranges" in inspect.signature(fn).parameters:
                params["ranges"] = ranges
            self.handler_params[name] = {k: v for k, v in params.items()
                                         if k not in ("processor", "ranges")}
            params = _known_kwargs(fn, params, name)
            self.preproc_fns.append(functools.partial(fn, **params))
            self.handler_names.append(name)
        dump_cfg = (cfg.get("processor") or {}).get("dump")
        self.dump = (DumpProcessor(**_known_kwargs(DumpProcessor, dict(dump_cfg), "dump"))
                     if dump_cfg else None)
        self.info = dict(info)
        self.datasets: tp.Dict[str, list] = {}
        self.samplers: tp.Dict[str, tp.Any] = {}

    @staticmethod
    def from_info(info: tp.Mapping,
                  ignored_handlers: tp.Optional[tp.Iterable[str]] = None) -> "DataPipeline":
        """Rebuild a pipeline from a ``get_info()`` payload."""
        return DataPipeline(info, ignored_handlers or ())

    @staticmethod
    def from_config(cfg: tp.Mapping,
                    seed_singletons: tp.Optional[tp.Mapping[str, dict]] = None
                    ) -> "DataPipeline":
        """The training pipeline of a data config; see the module docstring.
        ``seed_singletons`` maps a singleton handler's name to the state it
        loads before it is fitted (a checkpoint's ``pipeline_info["singletons"]``):
        the checkpoint's speaker and language ids stay, new ones are appended."""
        cfg = dict(cfg)
        ds_cfg = cfg.get("dataset") or {}
        subsets = list(ds_cfg.get("subsets", ["train", "test"]))
        root = (cfg.get("dirs") or {}).get("data_root", ".")
        ext = (cfg.get("file_search") or {}).get("ext", ".TextGridStage3")
        files = construct_file_list(root, ext=ext)
        train, test = split_file_list(files, float(ds_cfg.get("split_ratio", 0.9)),
                                      int(ds_cfg.get("seed", 0)))
        by_subset = {"train": train, "test": test}
        parser_cfg = dict(cfg.get("parser") or {})
        ptype = parser_cfg.pop("type", "SimpleDSParser")
        if ptype not in PARSERS:
            raise NotImplementedError(f"parser '{ptype}' is not ported")
        parser = PARSERS[ptype](**_known_kwargs(PARSERS[ptype], parser_cfg, ptype))
        maxn = ds_cfg.get("max_num_samples")
        datasets = {s: parser.read_datasamples(list(by_subset.get(s, files))[:maxn or None])
                    for s in subsets}
        if not datasets[subsets[0]]:
            raise ValueError(f"subset '{subsets[0]}' is empty (data_root={root}, ext={ext})")

        spec = cfg.get("singleton_handlers") or []
        items = spec.items() if isinstance(spec, dict) else [(n, {}) for n in spec]
        singletons = {}
        for name, kwargs in items:
            if name not in SINGLETON_HANDLERS:
                raise NotImplementedError(f"singleton handler '{name}' is not ported")
            singletons[name] = SINGLETON_HANDLERS[name](**dict(kwargs or {}))
            if seed_singletons and name in seed_singletons:
                singletons[name].load_state_dict(seed_singletons[name])
            singletons[name].fit(datasets[subsets[0]])
        for inst in singletons.values():
            if hasattr(inst, "apply"):
                for samples in datasets.values():
                    for ds in samples:
                        inst.apply(ds)

        alphabet = None
        if singletons.get("PhonemeStatistics") is not None \
                and singletons["PhonemeStatistics"].counts:
            alphabet = Alphabet(singletons["PhonemeStatistics"].symbols).to_dict()
        elif "text_to_transcription" in ((cfg.get("preproc") or {}).get("pipe") or []):
            alphabet = Alphabet([]).to_dict()
        info = {"config": cfg, "subsets": subsets, "alphabet": alphabet,
                "singletons": {n: inst.state_dict() for n, inst in singletons.items()},
                "dataset_sizes": {s: len(d) for s, d in datasets.items()}}
        dp = DataPipeline(info)
        dp.datasets = datasets
        section = cfg.get("sampler") or {}
        for s in subsets:
            s_cfg = dict(section[s] if isinstance(section.get(s), dict) else section)
            stype = s_cfg.pop("type", "SimpleSampler")
            if stype not in SAMPLERS:
                raise NotImplementedError(f"sampler '{stype}' is not ported")
            sampler = SAMPLERS[stype](**_known_kwargs(SAMPLERS[stype], s_cfg, stype))
            dp.samplers[s] = sampler.set_dataset(datasets[s])
        return dp

    def get_info(self) -> dict:
        """The config, subsets, alphabet, singleton states and dataset sizes."""
        return dict(self.info)

    @staticmethod
    def aggregate_info(infos: tp.Sequence[tp.Mapping]) -> dict:
        """Several pipelines' infos as one (the first's config): each singleton's
        states merged (``aggregate``), the dataset sizes summed, the alphabet
        rebuilt from the merged phoneme counts."""
        if not infos:
            return {}
        merged = dict(infos[0])
        merged["singletons"] = dict(merged.get("singletons") or {})
        merged["dataset_sizes"] = dict(merged.get("dataset_sizes") or {})
        for other in infos[1:]:
            for name, state in (other.get("singletons") or {}).items():
                if name not in merged["singletons"]:
                    merged["singletons"][name] = state
                    continue
                mine, theirs = SINGLETON_HANDLERS[name](), SINGLETON_HANDLERS[name]()
                mine.load_state_dict(merged["singletons"][name])
                theirs.load_state_dict(state)
                merged["singletons"][name] = mine.aggregate(theirs).state_dict()
            for s, n in (other.get("dataset_sizes") or {}).items():
                merged["dataset_sizes"][s] = merged["dataset_sizes"].get(s, 0) + n
        counts = (merged["singletons"].get("PhonemeStatistics") or {}).get("counts")
        if counts:
            merged["alphabet"] = Alphabet(sorted(counts)).to_dict()
        return merged

    def adopt_shared_state(self, info: tp.Mapping) -> None:
        """Take ``aggregate_info``'s singleton states and alphabet, and apply the
        singletons to this pipeline's samples again (their speaker and language
        ids become the merged ones)."""
        shared = dict(self.info, singletons=dict(info.get("singletons") or {}),
                      alphabet=info.get("alphabet") or self.info.get("alphabet"))
        rebuilt = DataPipeline(shared)
        self.__dict__.update({k: v for k, v in rebuilt.__dict__.items()
                              if k not in ("datasets", "samplers")})
        for name, state in self.singletons.items():
            inst = SINGLETON_HANDLERS[name]()
            inst.load_state_dict(state)
            if hasattr(inst, "apply"):
                for samples in self.datasets.values():
                    for ds in samples:
                        inst.apply(ds)

    def sample_batch(self, subset: str, batch_size: int) -> tp.Any:
        """The next batch of ``subset``'s sampler, processed and collated here
        (None if every sample of it failed)."""
        samples, _ = self.samplers[subset].sampling(batch_size)
        return self.process.batch(samples)

    @property
    def process(self) -> DataProcessor:
        """The training path's processing of a sample (through the cache)."""
        return DataProcessor(self.preproc_fns, self.collate_fn, self.handler_params,
                             dump_processor=self.dump)

    def loader(self, subset: str, batch_size: int, n_workers: int = 0,
               prefetch_factor: int = 2) -> "AudioLoader":
        """Endless batches of ``subset`` from ``n_workers`` worker processes."""
        return AudioLoader(self, subset, batch_size, n_workers, prefetch_factor)

    def datasample_to_batch(self, samples: tp.Sequence) -> tp.Any:
        """Every handler over every sample, then the collate. A failing
        sample raises: an inference request is never cut short silently."""
        processed = []
        for ds in samples:
            for fn in self.preproc_fns:
                ds = fn(ds)
            processed.append(ds)
        return self.collate_fn(processed)


class _SubsetSamples(torch.utils.data.Dataset):
    """Index in a subset -> the processed sample (or None)."""

    def __init__(self, samples: tp.Sequence, process: DataProcessor):
        self.samples = samples
        self.process = process

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int):
        return self.process.sample(self.samples[i])


def _as_is(sample):
    """The loader's per-sample collate: the processed sample itself."""
    return sample


class _SamplerIndices:
    """The sampler's batches, epoch after epoch, as one stream of sample indices;
    each batch's size is queued in ``sizes`` as its indices are handed out."""

    def __init__(self, sampler, batch_size: int):
        self.sampler = sampler
        self.batch_size = batch_size
        self.sizes: collections.deque = collections.deque()

    def __iter__(self):
        while True:
            samples, _ = self.sampler.sampling(self.batch_size)
            self.sizes.append(len(samples))
            yield from (s.index for s in samples)


class AudioLoader:
    """Batches of one subset from a ``torch.utils.data.DataLoader``: the
    sampler runs here and its batches go out as single samples to ``n_workers``
    worker processes (``concurrency.context.worker_context()``), which run the
    handlers (a batch's samples on all of them at once, so the first batch
    waits for a share of it, not for all of it); the collate runs here. Each worker keeps ``prefetch_factor`` batches' share of
    samples in flight (everything runs in this process when ``n_workers`` is 0).
    The workers start at the first ``next_batch()``, so a loader never read (a
    validation subset before its first validation) takes no host time from the
    others. A failing sample is left out of its batch; ``next_batch()`` skips a
    batch whose samples all failed; ``close()`` stops the workers."""

    def __init__(self, pipeline: DataPipeline, subset: str, batch_size: int,
                 n_workers: int = 0, prefetch_factor: int = 2):
        self._indices = _SamplerIndices(pipeline.samplers[subset], batch_size)
        self._collate = pipeline.collate_fn
        kwargs = dict(num_workers=n_workers)
        if n_workers > 0:
            kwargs.update(prefetch_factor=max(2, -(-prefetch_factor * batch_size // n_workers)),
                          multiprocessing_context=worker_context(),
                          worker_init_fn=functools.partial(adopt_environment,
                                                           dict(os.environ)))
        self._loader = torch.utils.data.DataLoader(
            _SubsetSamples(pipeline.datasets[subset], pipeline.process),
            sampler=self._indices, batch_size=None, collate_fn=_as_is, **kwargs)
        self._it = None

    def next_batch(self):
        if self._it is None:
            self._it = iter(self._loader)
        while True:
            first = next(self._it)  # drawing it queues its batch's size
            n = self._indices.sizes.popleft()
            kept = [s for s in [first, *(next(self._it) for _ in range(n - 1))]
                    if s is not None]
            if kept:
                return self._collate(kept)

    def close(self) -> None:
        """Stop the worker processes (the iterator's shutdown runs on release)."""
        self._it = None
        self._loader = None
