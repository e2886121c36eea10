"""A dataset of samples with cheap metadata (counterpart of
``speechflow_tpu/data/core/dataset.py``): each ``DatasetItem`` keeps a sample's
length, label and file path beside it, so samplers sort, filter and weight
without unpickling; with ``memory_save`` an item keeps only the sample's pickle
(``io.serialize.Serialize``) and unpickles it at each read."""

from __future__ import annotations

import typing as tp

from speechflow_torch.io.serialize import Serialize

__all__ = ["Dataset", "DatasetItem"]


class DatasetItem:
    __slots__ = ("_blob", "_obj", "length", "label", "file_path", "memory_save")

    def __init__(self, obj: tp.Any = None, blob: tp.Optional[bytes] = None,
                 memory_save: bool = False):
        self.memory_save = memory_save
        self.length = getattr(obj, "__len__", lambda: 1)() if obj is not None else 1
        self.label = getattr(obj, "label", None) if obj is not None else None
        self.file_path = getattr(obj, "file_path", None) if obj is not None else None
        if memory_save:
            self._blob = blob if blob is not None else Serialize.dump(obj)
            self._obj = None
        else:
            self._obj = obj
            self._blob = blob

    @property
    def obj(self) -> tp.Any:
        if self._obj is not None:
            return self._obj
        obj = Serialize.load(self._blob)
        if not self.memory_save:
            self._obj = obj
        return obj

    @property
    def blob(self) -> bytes:
        if self._blob is None:
            self._blob = Serialize.dump(self._obj)
        return self._blob


class Dataset:
    def __init__(self, items: tp.Optional[tp.Iterable] = None, memory_save: bool = False):
        self.memory_save = memory_save
        self._items: tp.List[DatasetItem] = []
        for it in items or ():
            self.append(it)

    def append(self, obj: tp.Any) -> None:
        self._items.append(obj if isinstance(obj, DatasetItem)
                           else DatasetItem(obj, memory_save=self.memory_save))

    def __len__(self) -> int:
        return len(self._items)

    def _with(self, items: tp.List[DatasetItem]) -> "Dataset":
        ds = Dataset(memory_save=self.memory_save)
        ds._items = items
        return ds

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self._with(self._items[idx])
        return self._items[idx].obj

    def __iter__(self):
        for it in self._items:
            yield it.obj

    def item(self, idx: int) -> DatasetItem:
        return self._items[idx]

    def sort(self, key: tp.Optional[tp.Callable] = None) -> "Dataset":
        self._items.sort(key=key or (lambda it: it.length))
        return self

    def filter(self, pred: tp.Callable[[tp.Any], bool]) -> "Dataset":
        return self._with([it for it in self._items if pred(it.obj)])

    def get_file_list(self) -> tp.List[str]:
        return [str(it.file_path) for it in self._items if it.file_path is not None]

    def labels(self) -> tp.List[tp.Optional[str]]:
        return [it.label for it in self._items]
