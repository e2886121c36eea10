"""Pickle framing of samples and batches (counterpart of
``speechflow_tpu/io/serialize.py``): protocol 5, and ``dump_frames`` /
``load_frames`` with numpy payloads out of band ([pickle, buffer, buffer, ...]),
the frames JAX's ZMQ data plane sends. The port's data server keeps its own
transport (``server/transport.py``). Unpickling runs code: load only bytes this
project wrote."""

from __future__ import annotations

import pickle
import typing as tp

__all__ = ["Serialize"]


class Serialize:
    PROTOCOL = 5

    @staticmethod
    def dump(obj: tp.Any) -> bytes:
        return pickle.dumps(obj, protocol=Serialize.PROTOCOL)

    @staticmethod
    def load(blob: bytes) -> tp.Any:
        return pickle.loads(blob)

    @staticmethod
    def dumps(objs: tp.Sequence[tp.Any]) -> tp.List[bytes]:
        return [Serialize.dump(o) for o in objs]

    @staticmethod
    def loads(blobs: tp.Sequence[bytes]) -> tp.List[tp.Any]:
        return [Serialize.load(b) for b in blobs]

    @staticmethod
    def size(obj: tp.Any) -> int:
        return len(Serialize.dump(obj))

    @staticmethod
    def dump_frames(obj: tp.Any) -> tp.List[tp.Union[bytes, memoryview]]:
        """[pickle bytes, buffer 0, buffer 1, ...]: the pickle holds the metadata and
        each numpy array's data travels as a raw buffer."""
        bufs: tp.List[memoryview] = []
        head = pickle.dumps(obj, protocol=Serialize.PROTOCOL,
                            buffer_callback=lambda b: bufs.append(b.raw()))
        return [head, *bufs]

    @staticmethod
    def load_frames(frames: tp.Sequence[tp.Union[bytes, memoryview]],
                    writable: bool = False) -> tp.Any:
        """The inverse of ``dump_frames`` (a plain one-frame pickle too). The arrays
        are read-only views over the frames unless ``writable`` (then each buffer
        is copied once)."""
        bufs = [bytearray(b) for b in frames[1:]] if writable else frames[1:]
        return pickle.loads(frames[0], buffers=bufs)
