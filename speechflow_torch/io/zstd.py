"""Zstandard frame decompression (read only) over the system's ``libzstd``.

The JAX package's checkpoints hold zstd frames twice over: OCDBT compresses
its manifests and B-tree nodes, and orbax's zarr arrays compress each chunk
(``compressor: {"id": "zstd"}``). The machine with the GPU has ``libzstd.so.1``
but no Python binding for it, so this module binds the C API with ``ctypes``,
as ``speechflow_tpu/io/codecs.py`` binds the audio codecs: the library is
loaded at the first call, and ``decompress`` raises ``RuntimeError`` naming it
where it cannot be loaded.

- A single frame that records its content size goes through
  ``ZSTD_decompress`` into a buffer of exactly that size.
- Anything else (a frame written by a stream without a content size, or
  several frames back to back) goes through the streaming API
  (``ZSTD_decompressStream``), which grows the output as it goes.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import typing as tp

__all__ = ["decompress"]

_CONTENTSIZE_UNKNOWN = 2 ** 64 - 1
_CONTENTSIZE_ERROR = 2 ** 64 - 2


class _Buffer(ctypes.Structure):
    """``ZSTD_inBuffer`` and ``ZSTD_outBuffer`` share this layout."""
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


_LIB: tp.Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        path = ctypes.util.find_library("zstd") or "libzstd.so.1"
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise RuntimeError(f"zstd decompression needs the system library libzstd "
                               f"(libzstd.so.1), which could not be loaded: {e}") from e
        size_t, vp = ctypes.c_size_t, ctypes.c_void_p
        for name, res, args in (
                ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [vp, size_t]),
                ("ZSTD_findFrameCompressedSize", size_t, [vp, size_t]),
                ("ZSTD_decompress", size_t, [vp, size_t, vp, size_t]),
                ("ZSTD_isError", ctypes.c_uint, [size_t]),
                ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
                ("ZSTD_createDStream", vp, []),
                ("ZSTD_freeDStream", size_t, [vp]),
                ("ZSTD_initDStream", size_t, [vp]),
                ("ZSTD_DStreamOutSize", size_t, []),
                ("ZSTD_decompressStream", size_t,
                 [vp, ctypes.POINTER(_Buffer), ctypes.POINTER(_Buffer)])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _LIB = lib
    return _LIB


def _check(lib: ctypes.CDLL, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def decompress(data: tp.Union[bytes, bytearray, memoryview]) -> bytes:
    """The bytes that the zstd frame or frames in ``data`` hold; ``ValueError``
    for a corrupt or truncated input."""
    lib = _lib()
    src = bytes(data)
    size = lib.ZSTD_getFrameContentSize(src, len(src))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("zstd: not a zstd frame")
    if size != _CONTENTSIZE_UNKNOWN and _check(
            lib, lib.ZSTD_findFrameCompressedSize(src, len(src)), "frame") == len(src):
        dst = ctypes.create_string_buffer(max(size, 1))
        n = _check(lib, lib.ZSTD_decompress(dst, size, src, len(src)), "decompress")
        if n != size:
            raise ValueError(f"zstd: frame gave {n} bytes, its header says {size}")
        return dst.raw[:n]
    return _stream(lib, src)


def _stream(lib: ctypes.CDLL, src: bytes) -> bytes:
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("ZSTD_createDStream")
    try:
        _check(lib, lib.ZSTD_initDStream(stream), "init")
        chunk = lib.ZSTD_DStreamOutSize()
        out = ctypes.create_string_buffer(chunk)
        inb = _Buffer(ctypes.cast(ctypes.c_char_p(src), ctypes.c_void_p), len(src), 0)
        parts: tp.List[bytes] = []
        while True:
            outb = _Buffer(ctypes.cast(out, ctypes.c_void_p), chunk, 0)
            before = inb.pos
            left = _check(lib, lib.ZSTD_decompressStream(stream, ctypes.byref(outb),
                                                         ctypes.byref(inb)), "stream")
            parts.append(out.raw[:outb.pos])
            if left == 0 and inb.pos == inb.size:
                break  # the last frame is decoded and flushed
            if inb.pos == before and outb.pos == 0:
                raise ValueError("zstd: truncated frame")
        return b"".join(parts)
    finally:
        lib.ZSTD_freeDStream(stream)
