"""The dataset parser base (counterpart of ``speechflow_tpu/data/core/parser.py``).

``BaseDSParser.read_datasamples(files)`` maps each file through ``reader``
(file -> metadata dicts), each metadata dict through the ``preproc_fns`` in
order (one returning None drops the record) and the survivors through
``to_datasample`` (None drops it too). Files go in chunks of ``chunk_size``;
with ``n_processes > 1`` and more than one chunk, the chunks run in a pool of
worker processes (``concurrency.context``; the parser and its functions must
pickle). A file that raises is
skipped with a warning when ``skip_corrupted``, else the error propagates. With
``cache_dir`` the parsed list is pickled there as ``parsed_<key>.pkl``, the key
JAX's (the sorted files, the preproc functions' names, the parser's class), and
read back on the next call with the same key. The samples come back as a list
in file order, each ``index`` its position; JAX's pool returns its chunks in
the order they finish.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import typing as tp
from pathlib import Path

from speechflow_torch.concurrency.context import adopt_environment, worker_context
from speechflow_torch.data.core.dataset import Dataset

__all__ = ["BaseDSParser", "Metadata"]

LOGGER = logging.getLogger("speechflow_torch")

Metadata = tp.Dict[str, tp.Any]


def _process_chunk(args) -> list:
    parser, files = args
    out = []
    for f in files:
        try:
            for md in parser.reader(f):
                md = parser.run_preprocessing(md)
                if md is not None:
                    ds = parser.to_datasample(md)
                    if ds is not None:
                        out.append(ds)
        except Exception as e:
            LOGGER.warning("parser failed on %s: %r", f, e)
            if not parser.skip_corrupted:
                raise
    return out


class BaseDSParser:
    """Subclasses implement ``reader`` and ``to_datasample``."""

    def __init__(self, preproc_fns: tp.Optional[tp.Sequence[
                     tp.Callable[[Metadata], tp.Optional[Metadata]]]] = None,
                 n_processes: int = 0, chunk_size: int = 100, skip_corrupted: bool = True,
                 cache_dir: tp.Optional[tp.Union[str, Path]] = None):
        self.preproc_fns = list(preproc_fns or [])
        self.n_processes = n_processes
        self.chunk_size = chunk_size
        self.skip_corrupted = skip_corrupted
        self.cache_dir = Path(cache_dir) if cache_dir else None

    def reader(self, path: tp.Union[str, Path]) -> tp.List[Metadata]:
        raise NotImplementedError

    def to_datasample(self, md: Metadata):
        raise NotImplementedError

    def run_preprocessing(self, md: Metadata) -> tp.Optional[Metadata]:
        for fn in self.preproc_fns:
            md = fn(md)
            if md is None:
                return None
        return md

    def _cache_key(self, files: tp.Sequence) -> str:
        blob = repr((sorted(str(f) for f in files),
                     [getattr(f, "__name__", str(f)) for f in self.preproc_fns],
                     type(self).__name__)).encode()
        return hashlib.sha256(blob).hexdigest()[:24]

    def read_datasamples(self, files: tp.Sequence[tp.Union[str, Path]],
                         memory_save: bool = False,
                         progress: bool = False) -> tp.Union[list, Dataset]:
        """The samples of ``files``: a list, or with ``memory_save`` a
        ``Dataset`` that keeps each sample pickled until it is read. With
        ``progress`` each finished chunk is logged."""
        cache_file = None
        samples: list = []
        if self.cache_dir is not None:
            cache_file = self.cache_dir / f"parsed_{self._cache_key(files)}.pkl"
            if cache_file.exists():
                LOGGER.info("parser cache hit: %s", cache_file)
                samples = pickle.loads(cache_file.read_bytes())
                return Dataset(samples, memory_save=True) if memory_save else samples

        chunks = [list(files[i:i + self.chunk_size])
                  for i in range(0, len(files), self.chunk_size)]
        if self.n_processes > 1 and len(chunks) > 1:
            with worker_context().Pool(self.n_processes, initializer=adopt_environment,
                                       initargs=(dict(os.environ),)) as pool:
                parts = pool.imap(_process_chunk, [(self, c) for c in chunks])
                for k, part in enumerate(parts):
                    samples.extend(part)
                    if progress:
                        LOGGER.info("parsed %d/%d chunks", k + 1, len(chunks))
        else:
            for k, c in enumerate(chunks):
                samples.extend(_process_chunk((self, c)))
                if progress:
                    LOGGER.info("parsed %d/%d chunks", k + 1, len(chunks))
        for i, s in enumerate(samples):
            s.index = i

        if cache_file is not None:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
            cache_file.write_bytes(pickle.dumps(samples, protocol=5))
        return Dataset(samples, memory_save=True) if memory_save else samples
