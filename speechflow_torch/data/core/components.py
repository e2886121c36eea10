"""Data pipelines (counterpart of ``DataPipeline`` in
``speechflow_tpu/data/core/components.py``).

Two ways in:

- ``from_info(payload["pipeline_info"], datasets, ignored_fields,
  ignored_handlers)`` rebuilds the handler chain of ``preproc.pipe`` and the
  collate from the plain dict a trainer stores (the resolved data config, the
  alphabet and each singleton handler's state), for inference. Handlers in
  ``ignored_handlers``, and those that write a field of ``ignored_fields``, are
  left out; a name no handler has raises ``KeyError`` with it. Singletons stay
  as their state dicts (``pipeline.singletons[name]``).
- ``DataPipeline(cfg).init_components()`` (``from_config(cfg)``;
  ``init_from_config(path, value_select)`` reads the file) builds the training
  pipeline from a data config (the sections of ``configs/vocoder_data_24khz.yml``):
  the files of ``dirs.data_root`` with ``file_search.ext``, split by
  ``dataset.split_ratio`` (seeded), cut to ``max_num_samples``, parsed
  (``parser.type``), the singleton handlers fitted on the first subset and
  applied to every subset, and a sampler per subset (``sampler``).
  ``pipeline[subset]`` is that subset's ``PipelineComponents``, JAX's steps by
  name over the same state. ``get_info()`` is what a checkpoint carries;
  ``sample_batch`` draws and collates one batch in this process; ``loader``
  serves batches from PyTorch DataLoader worker processes (``n_workers``,
  ``prefetch_factor``), the one-host counterpart of the JAX data server.

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
from speechflow_torch.data.core.batch import Batch
from speechflow_torch.data.core.processor import DataProcessor, DumpProcessor
from speechflow_torch.data.core.registry import PipeRegistry
from speechflow_torch.data.parsers import PARSERS
from speechflow_torch.data.processors import get_handler
from speechflow_torch.data.processors.singletons import SINGLETON_HANDLERS, StatisticsRange
from speechflow_torch.data.processors.text import Alphabet, TTSTextProcessor
from speechflow_torch.data.samplers import SAMPLERS
from speechflow_torch.io.config import Config
from speechflow_torch.io.flist import construct_file_list, split_file_list

__all__ = ["PipelineComponents", "DataPipeline", "AudioLoader"]

LOGGER = logging.getLogger("speechflow_torch")


def _known_kwargs(fn: tp.Callable, params: dict, what: str) -> dict:
    """``params`` that ``fn`` takes; the others are dropped with a warning."""
    names = set(inspect.signature(fn).parameters)
    dropped = sorted(set(params) - names)
    if dropped:
        LOGGER.warning("%s: ignoring unknown parameters %s", what, dropped)
    return {k: v for k, v in params.items() if k in names}


class PipelineComponents:
    """One subset of a ``DataPipeline``, under JAX's names: a view over the
    state the pipeline keeps for that subset (its samples and sampler) and
    for all of them (the parser, the singletons, the handler chain and the
    collate). ``sample_batch`` and ``datasample_to_batch`` return the data
    processor's ``Batch`` (``collated_samples`` is the collated batch)."""

    def __init__(self, cfg: tp.Optional[tp.Mapping] = None, subset: str = "train",
                 ignored_fields: tp.Optional[tp.Iterable[str]] = None,
                 ignored_handlers: tp.Optional[tp.Iterable[str]] = None,
                 pipeline: tp.Optional["DataPipeline"] = None):
        """A view over ``pipeline``'s state, or (JAX's call) over a new pipeline
        of the data config ``cfg``."""
        self.pipeline = pipeline if pipeline is not None else \
            DataPipeline(cfg, ignored_fields, ignored_handlers)
        self.subset = subset
        #: the fitted singleton handlers, by name (set by ``fit_singletons``)
        self.singletons: tp.Dict[str, tp.Any] = {}

    @property
    def cfg(self) -> Config:
        return self.pipeline.cfg

    @property
    def dataset(self) -> tp.Optional[tp.Sequence]:
        return self.pipeline.datasets.get(self.subset)

    @property
    def sampler(self) -> tp.Any:
        return self.pipeline.samplers.get(self.subset)

    @property
    def parser(self) -> tp.Any:
        return self.pipeline.parser

    @property
    def collate_fn(self) -> tp.Callable:
        return self.pipeline.collate_fn

    @property
    def preproc_fns(self) -> tp.List[tp.Callable]:
        return self.pipeline.preproc_fns

    @property
    def data_processor(self) -> DataProcessor:
        return self.pipeline.process

    def load_dataset(self, files: tp.Sequence) -> tp.Sequence:
        """Parse ``files`` (the first ``dataset.max_num_samples``) as this
        subset's samples."""
        maxn = (self.cfg.get("dataset") or {}).get("max_num_samples")
        self.set_dataset(self.parser.read_datasamples(list(files)[:maxn or None]))
        return self.dataset

    def set_dataset(self, dataset: tp.Sequence) -> None:
        self.pipeline.datasets[self.subset] = dataset

    def fit_singletons(self, shared: tp.Optional[tp.Mapping[str, tp.Any]] = None,
                       seed: tp.Optional[tp.Mapping[str, dict]] = None) -> None:
        """Fit the config's ``singleton_handlers`` on this subset (each first
        loading ``seed[name]``, a checkpoint's state), or take ``shared``'s
        fitted ones; then apply them to this subset's samples. The pipeline
        keeps their states."""
        spec = self.cfg.get("singleton_handlers") or []
        items = spec.items() if isinstance(spec, dict) else [(n, {}) for n in spec]
        for name, kwargs in items:
            if shared and name in shared:
                inst = shared[name]
            else:
                if name not in SINGLETON_HANDLERS:
                    raise NotImplementedError(f"singleton handler '{name}' is not ported")
                inst = SINGLETON_HANDLERS[name](**dict(kwargs or {}))
                if seed and name in seed:
                    inst.load_state_dict(seed[name])
                inst.fit(self.dataset)
            self.singletons[name] = inst
            self.pipeline.singletons[name] = inst.state_dict()
        for inst in self.singletons.values():
            for ds in self.dataset or ():
                inst.apply(ds)

    def build_preproc(self, alphabet: tp.Optional[Alphabet] = None) -> None:
        """The handler chain of ``preproc.pipe`` over ``alphabet``."""
        self.pipeline.alphabet = alphabet
        self.pipeline.build_preproc()

    def attach_sampler(self) -> None:
        """This subset's sampler (``sampler.<subset>``, else ``sampler``) over
        its samples."""
        section = self.cfg.get("sampler") or {}
        s_cfg = dict(section[self.subset] if isinstance(section.get(self.subset), dict)
                     else section)
        stype = s_cfg.pop("type", "SimpleSampler")
        if stype not in SAMPLERS:
            raise NotImplementedError(f"sampler '{stype}' is not ported")
        sampler = SAMPLERS[stype](**_known_kwargs(SAMPLERS[stype], s_cfg, stype))
        self.pipeline.samplers[self.subset] = sampler.set_dataset(self.dataset)

    def datasample_to_batch(self, samples: tp.Sequence) -> tp.Optional[Batch]:
        """``samples`` (changed in place) through the data processor."""
        return self.data_processor.process(list(samples))

    def sample_batch(self, batch_size: int) -> tp.Optional[Batch]:
        """The sampler's next batch, copies of its samples processed."""
        samples, is_last = self.sampler.sampling(batch_size)
        return self.data_processor.process([s.copy() for s in samples], is_last=is_last)


class DataPipeline:
    """A data config's pipeline: ``DataPipeline(cfg)`` then ``init_components()``
    (or ``from_config``) for training, ``from_info`` for inference. Handlers in
    ``ignored_handlers``, and those writing a field of ``ignored_fields``, are
    left out of the chain."""

    def __init__(self, cfg: tp.Mapping,
                 ignored_fields: tp.Optional[tp.Iterable[str]] = None,
                 ignored_handlers: tp.Optional[tp.Iterable[str]] = None):
        if "config" in cfg and ({"subsets", "singletons"} & set(cfg)):
            raise TypeError("DataPipeline takes a data config; build a pipeline from a "
                            "get_info() payload with DataPipeline.from_info")
        self.cfg = cfg if isinstance(cfg, Config) else Config(cfg)
        self.ignored_fields = set(ignored_fields or ())
        self.ignored_handlers = set(ignored_handlers or ())
        self.subsets: tp.List[str] = list((self.cfg.get("dataset") or {}).get(
            "subsets", ["train", "test"]))
        preproc = self.cfg.get("preproc") or {}
        for module in preproc.get("imports") or []:  # modules that register handlers, collates
            importlib.import_module(module)
        collate_cfg = dict(self.cfg.get("collate") or {})
        ctype = collate_cfg.pop("type", "none")
        if ctype not in COLLATES:
            raise NotImplementedError(f"collate '{ctype}' is not ported")
        self.collate_fn = COLLATES[ctype](**_known_kwargs(COLLATES[ctype], collate_cfg, ctype))
        dump_cfg = (self.cfg.get("processor") or {}).get("dump")
        self.dump = (DumpProcessor(**_known_kwargs(DumpProcessor, dict(dump_cfg), "dump"))
                     if dump_cfg else None)
        self.alphabet: tp.Optional[Alphabet] = None
        #: each singleton handler's state, by name
        self.singletons: tp.Dict[str, dict] = {}
        self.text_processor: tp.Optional[TTSTextProcessor] = None
        self.preproc_fns: tp.List[tp.Callable] = []
        self.handler_names: tp.List[str] = []
        #: each handler's config parameters, which key its cached fields
        self.handler_params: tp.Dict[str, dict] = {}
        self.datasets: tp.Dict[str, tp.Sequence] = {}
        self.samplers: tp.Dict[str, tp.Any] = {}
        self.components: tp.Dict[str, PipelineComponents] = {}
        self._sizes: tp.Dict[str, int] = {}
        self._extra: tp.Dict[str, tp.Any] = {}

    # -- construction -------------------------------------------------------------

    @staticmethod
    def init_from_config(path: tp.Union[str, os.PathLike],
                         value_select: tp.Optional[tp.Sequence[str]] = None,
                         **kwargs) -> "DataPipeline":
        """The pipeline of a data config file (not initialised yet)."""
        return DataPipeline(Config.create_from_file(path, value_select=value_select), **kwargs)

    def with_ignored_fields(self, fields: tp.Iterable[str]) -> "DataPipeline":
        """A new pipeline of this config that also ignores ``fields``."""
        return DataPipeline(self.cfg, self.ignored_fields | set(fields), self.ignored_handlers)

    def with_ignored_handlers(self, handlers: tp.Iterable[str]) -> "DataPipeline":
        """A new pipeline of this config that also leaves out ``handlers``."""
        return DataPipeline(self.cfg, self.ignored_fields, self.ignored_handlers | set(handlers))

    @property
    def parser(self) -> tp.Any:
        """The config's ``parser`` section's parser."""
        parser_cfg = dict(self.cfg.get("parser") or {})
        ptype = parser_cfg.pop("type", "SimpleDSParser")
        if ptype not in PARSERS:
            raise NotImplementedError(f"parser '{ptype}' is not ported")
        return PARSERS[ptype](**_known_kwargs(PARSERS[ptype], parser_cfg, ptype))

    def __getitem__(self, subset: str) -> PipelineComponents:
        if subset not in self.components:
            self.components[subset] = PipelineComponents(subset=subset, pipeline=self)
        return self.components[subset]

    def init_components(self, datasets: tp.Optional[tp.Mapping[str, tp.Sequence]] = None,
                        seed_singletons: tp.Optional[tp.Mapping[str, dict]] = None
                        ) -> "DataPipeline":
        """The training pipeline; see the module docstring. ``datasets`` gives
        each subset's samples instead of parsing ``dirs.data_root``;
        ``seed_singletons`` maps a singleton handler's name to the state it
        loads before it is fitted (a checkpoint's ``pipeline_info["singletons"]``):
        the checkpoint's speaker and language ids stay, new ones are appended."""
        ds_cfg = self.cfg.get("dataset") or {}
        if datasets is None:
            root = (self.cfg.get("dirs") or {}).get("data_root", ".")
            ext = (self.cfg.get("file_search") or {}).get("ext", ".TextGridStage3")
            files = construct_file_list(root, ext=ext)
            train, test = split_file_list(files, float(ds_cfg.get("split_ratio", 0.9)),
                                          int(ds_cfg.get("seed", 0)))
            by_subset = {"train": train, "test": test}
            for s in self.subsets:
                self[s].load_dataset(by_subset.get(s, files))
            if not self.datasets[self.subsets[0]]:
                raise ValueError(f"subset '{self.subsets[0]}' is empty "
                                 f"(data_root={root}, ext={ext})")
        else:
            for s in self.subsets:
                self[s].set_dataset(datasets[s])
        first = self[self.subsets[0]]
        first.fit_singletons(seed=seed_singletons)
        for s in self.subsets[1:]:
            self[s].fit_singletons(shared=first.singletons)
        phst = first.singletons.get("PhonemeStatistics")
        alphabet = None
        if phst is not None and phst.counts:
            alphabet = Alphabet(phst.symbols)
        elif "text_to_transcription" in ((self.cfg.get("preproc") or {}).get("pipe") or []):
            alphabet = Alphabet([])
        self.alphabet = alphabet
        self.build_preproc()
        for s in self.subsets:
            self[s].attach_sampler()
        return self

    @staticmethod
    def from_config(cfg: tp.Mapping,
                    seed_singletons: tp.Optional[tp.Mapping[str, dict]] = None
                    ) -> "DataPipeline":
        """``DataPipeline(cfg).init_components(seed_singletons=...)``."""
        return DataPipeline(cfg).init_components(seed_singletons=seed_singletons)

    @staticmethod
    def from_info(info: tp.Mapping,
                  datasets: tp.Optional[tp.Mapping[str, tp.Sequence]] = None,
                  ignored_fields: tp.Optional[tp.Iterable[str]] = None,
                  ignored_handlers: tp.Optional[tp.Iterable[str]] = None) -> "DataPipeline":
        """Rebuild a pipeline from a ``get_info()`` payload; with ``datasets``,
        their subsets get the singletons applied and a sampler."""
        dp = DataPipeline(info["config"], ignored_fields, ignored_handlers)
        dp.subsets = list(info.get("subsets") or dp.subsets)
        dp.alphabet = Alphabet.from_dict(info["alphabet"]) if info.get("alphabet") else None
        dp.singletons = dict(info.get("singletons") or {})
        dp._sizes = dict(info.get("dataset_sizes") or {})
        dp._extra = {k: v for k, v in info.items()
                     if k not in ("config", "subsets", "alphabet", "singletons", "dataset_sizes")}
        dp.build_preproc()
        for subset in dp.subsets:
            if datasets and subset in datasets:
                dp[subset].set_dataset(datasets[subset])
                dp._apply_singletons(subset)
                dp[subset].attach_sampler()
        return dp

    def build_preproc(self) -> None:
        """The handler chain of ``preproc.pipe`` over the pipeline's alphabet and
        singletons (``normalize``'s ``ranges`` is the ``StatisticsRange``)."""
        preproc = self.cfg.get("preproc") or {}
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
        self.preproc_fns, self.handler_names, self.handler_params = [], [], {}
        for name in preproc.get("pipe") or []:
            if name in self.ignored_handlers:
                continue
            fn = get_handler(name)
            if PipeRegistry.meta(fn)["outputs"] & self.ignored_fields:
                continue
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

    def _apply_singletons(self, subset: str) -> None:
        for name, state in self.singletons.items():
            inst = SINGLETON_HANDLERS[name]()
            inst.load_state_dict(state)
            for ds in self.datasets.get(subset) or ():
                inst.apply(ds)

    # -- info -------------------------------------------------------------------

    def get_info(self) -> dict:
        """The config, subsets, alphabet, singleton states and dataset sizes."""
        sizes = dict(self._sizes, **{s: len(d) for s, d in self.datasets.items()})
        return dict(self._extra, config=self.cfg.to_dict(), subsets=list(self.subsets),
                    alphabet=self.alphabet.to_dict() if self.alphabet else None,
                    singletons=dict(self.singletons), dataset_sizes=sizes)

    @property
    def info(self) -> dict:
        return self.get_info()

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
        self.singletons = dict(info.get("singletons") or {})
        if info.get("alphabet"):
            self.alphabet = Alphabet.from_dict(info["alphabet"])
        self.build_preproc()
        for subset in self.datasets:
            self._apply_singletons(subset)

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
