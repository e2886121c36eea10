"""A read-only OCDBT key-value store (tensorstore's "Optionally-Cooperative
Distributed B+Tree"), the store under orbax's checkpoints.

An orbax checkpoint directory holds ``manifest.ocdbt`` and ``d/<id>`` data
files at its top, and the same under ``ocdbt.process_<n>/`` for each writing
process; every key is in the top store once orbax has finished. This module
reads one such store without tensorstore:

- every encoded file and node starts with a magic number (uint32, big-endian),
  its total length (uint64 LE), a format version (varint) and a compression
  method (varint: 0 none, 1 zstd), and ends with the CRC-32C (LE) of all bytes
  before it, which is checked;
- the manifest holds the store's config, a table of data files and the
  newest versions of the version tree, each with its B-tree root (file,
  offset, length, height); the newest version is the store's content (older
  versions, in version-tree nodes, are not read);
- B-tree nodes: height 0 is a leaf of (key, value), a value inline or a
  reference (file, offset, length) into a data file; height > 0 is an interior
  node of (first key, child reference). Keys are prefix-compressed against the
  entry before them, and each child drops the ``subtree_common_prefix`` that
  its parent records, which the reader adds back.

Integers are LEB128 varints; each section of a node stores a field for all
its entries before the next field ("columnar"). ``keys()`` and ``read(key)``
match tensorstore's ``KvStore.list()`` and ``read()`` byte for byte.
"""

from __future__ import annotations

import struct
import typing as tp
from pathlib import Path

from speechflow_torch.io import zstd

__all__ = ["OcdbtStore", "crc32c"]

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_NODE_MAGIC = 0x0CDB20DE
_EMPTY = 2 ** 64 - 1  # the offset and length of an empty tree's root


def _crc_table() -> tp.List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT's footers hold it."""
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """A cursor over a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated at byte {self.pos}")

    def varint(self) -> int:
        out = shift = 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long at byte {self.pos}")

    def varints(self, n: int) -> tp.List[int]:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def raw(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u64s(self, n: int) -> tp.List[int]:
        return list(struct.unpack(f"<{n}Q", self.raw(8 * n)))

    def done(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} bytes left over")


def decode_envelope(data: bytes, magic: int, what: str) -> bytes:
    """The body of an encoded manifest or node, checksum checked and
    decompressed."""
    if len(data) < 18:
        raise ValueError(f"{what}: {len(data)} bytes is too short")
    found, length = struct.unpack(">I", data[:4])[0], struct.unpack("<Q", data[4:12])[0]
    if found != magic:
        raise ValueError(f"{what}: magic {found:#010x}, expected {magic:#010x}")
    if length != len(data):
        raise ValueError(f"{what}: header says {length} bytes, found {len(data)}")
    want = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != want:
        raise ValueError(f"{what}: CRC-32C mismatch (corrupt file)")
    r = _Reader(data[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version} is not supported")
    method = r.varint()
    body = data[r.pos:-4]
    if method == 0:
        return body
    if method == 1:
        return zstd.decompress(body)
    raise ValueError(f"{what}: compression method {method} is not supported")


def _data_file_table(r: _Reader) -> tp.List[str]:
    """Data file paths, each relative to the store's root: ``n``, the prefix
    each path shares with the one before it, the suffix lengths, the base-path
    lengths (where the writer split base path and name; not needed to read),
    then the suffixes' bytes."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)
    paths: tp.List[str] = []
    prev = b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f"{r.what}: bad path prefix length {p}")
        prev = prev[:p] + r.raw(s)
        paths.append(prev.decode())
    return paths


def _keys(r: _Reader, n: int, interior: bool
          ) -> tp.Tuple[tp.List[bytes], tp.List[int]]:
    """A node's keys and, in an interior node, each child's common prefix
    length: the prefix lengths (shared with the key before), the suffix
    lengths, [the common prefix lengths,] then the suffixes' bytes."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys: tp.List[bytes] = []
    prev = b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f"{r.what}: bad key prefix length {p}")
        prev = prev[:p] + r.raw(s)
        keys.append(prev)
    return keys, common


class _Ref(tp.NamedTuple):
    file: str
    offset: int
    length: int


class OcdbtStore:
    """The newest version of the OCDBT store under ``root`` (the directory that
    holds ``manifest.ocdbt``): ``keys()`` lists its keys in order, ``read(key)``
    returns a value's bytes (``KeyError`` if absent). ``ValueError`` for a
    corrupt or unsupported file, ``FileNotFoundError`` without a manifest."""

    def __init__(self, root: tp.Union[str, Path]):
        self.root = Path(root)
        manifest = self.root / "manifest.ocdbt"
        if not manifest.is_file():
            raise FileNotFoundError(f"{manifest}: no OCDBT manifest")
        self._files: tp.Dict[str, bytes] = {}
        self._values: tp.Optional[tp.Dict[bytes, tp.Union[bytes, _Ref]]] = None
        self._root_ref, self._root_height = self._read_manifest(manifest.read_bytes())

    # -- manifest -------------------------------------------------------------

    def _read_manifest(self, data: bytes) -> tp.Tuple[tp.Optional[_Ref], int]:
        what = str(self.root / "manifest.ocdbt")
        r = _Reader(decode_envelope(data, MANIFEST_MAGIC, what), what)
        r.raw(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{what}: manifest kind {kind} (numbered manifests) is not "
                             "supported; orbax writes single-file manifests")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        arity_log2 = r.u8()
        if r.varint() == 1:
            r.raw(4)  # zstd level, int32
        files = _data_file_table(r)
        # the version tree's leaf: the newest versions, columnar
        n = r.varint()
        if n == 0:
            return None, 0
        if n > 1 << arity_log2:
            raise ValueError(f"{what}: {n} inline versions exceed the arity")
        gens = r.varints(n)
        heights = [r.u8() for _ in range(n)]
        file_ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
        r.u64s(n)  # commit times
        self._skip_version_nodes(r)
        r.done()
        last = max(range(n), key=gens.__getitem__)
        if offsets[last] == _EMPTY and lengths[last] == _EMPTY:
            return None, 0
        return _Ref(self._file(files, file_ids[last], what), offsets[last],
                    lengths[last]), heights[last]

    @staticmethod
    def _skip_version_nodes(r: _Reader) -> None:
        """References to the version tree's interior nodes (older versions):
        generation, file, offset, length, generation count, commit time, height."""
        n = r.varint()
        r.varints(5 * n)
        r.u64s(n)
        r.raw(n)

    def _file(self, files: tp.Sequence[str], i: int, what: str) -> str:
        if i >= len(files):
            raise ValueError(f"{what}: data file {i} is not in its table of {len(files)}")
        return files[i]

    # -- B-tree ---------------------------------------------------------------

    def _bytes(self, ref: _Ref) -> bytes:
        data = self._files.get(ref.file)
        if data is None:
            path = self.root / ref.file
            if not path.is_file():
                raise FileNotFoundError(f"{path}: data file of the OCDBT store is missing")
            data = self._files[ref.file] = path.read_bytes()
        if ref.offset + ref.length > len(data):
            raise ValueError(f"{self.root / ref.file}: reference past its end")
        return data[ref.offset:ref.offset + ref.length]

    def _walk(self, ref: _Ref, height: int, prefix: bytes,
              out: tp.Dict[bytes, tp.Union[bytes, _Ref]]) -> None:
        what = f"{self.root / ref.file}@{ref.offset}"
        r = _Reader(decode_envelope(self._bytes(ref), BTREE_NODE_MAGIC, what), what)
        h = r.u8()
        if h != height:
            raise ValueError(f"{what}: node height {h}, its parent says {height}")
        files = _data_file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, interior=h > 0)
        if h == 0:
            lengths = r.varints(n)
            kinds = [r.u8() for _ in range(n)]
            indirect = [i for i, k in enumerate(kinds) if k == 1]
            if any(k not in (0, 1) for k in kinds):
                raise ValueError(f"{what}: unknown value kind")
            file_ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
            refs = {i: _Ref(self._file(files, f, what), o, lengths[i])
                    for i, f, o in zip(indirect, file_ids, offsets)}
            for i, key in enumerate(keys):
                out[prefix + key] = refs[i] if i in refs else r.raw(lengths[i])
            r.done()
            return
        file_ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics
        r.done()
        for i, key in enumerate(keys):
            if common[i] > len(key):
                raise ValueError(f"{what}: common prefix longer than its key")
            self._walk(_Ref(self._file(files, file_ids[i], what), offsets[i], lengths[i]),
                       h - 1, prefix + key[:common[i]], out)

    def _index(self) -> tp.Dict[bytes, tp.Union[bytes, _Ref]]:
        if self._values is None:
            values: tp.Dict[bytes, tp.Union[bytes, _Ref]] = {}
            if self._root_ref is not None:
                self._walk(self._root_ref, self._root_height, b"", values)
            self._values = values
        return self._values

    # -- API --------------------------------------------------------------------

    def keys(self) -> tp.List[bytes]:
        return sorted(self._index())

    def read(self, key: tp.Union[str, bytes]) -> bytes:
        k = key.encode() if isinstance(key, str) else key
        v = self._index().get(k)
        if v is None:
            raise KeyError(key)
        return self._bytes(v) if isinstance(v, _Ref) else v
