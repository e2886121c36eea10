"""A metaclass of one instance per class, process and thread (counterpart of
``speechflow_tpu/data/core/singleton.py``): ``Singleton.clear()`` forgets every
instance, ``Singleton.clear(cls)`` those of one class. The port's dataset-level
handlers are plain objects a pipeline owns (``data/processors/singletons.py``);
this is for code that wants JAX's process-wide behaviour."""

from __future__ import annotations

import threading

__all__ = ["Singleton"]


class Singleton(type):
    _instances: dict = {}
    _lock = threading.Lock()

    def __call__(cls, *args, **kwargs):
        key = (cls, threading.get_ident())
        if key not in cls._instances:
            with cls._lock:
                if key not in cls._instances:
                    cls._instances[key] = super().__call__(*args, **kwargs)
        return cls._instances[key]

    @classmethod
    def clear(mcs, klass=None) -> None:
        with mcs._lock:
            if klass is None:
                mcs._instances.clear()
            else:
                for k in [k for k in mcs._instances if k[0] is klass]:
                    del mcs._instances[k]
