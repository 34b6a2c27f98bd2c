"""A read-only view of a tensorstore OCDBT key-value store in a directory:
the layout Orbax writes a checkpoint in by default (``use_ocdbt``; JAX
counterpart: utils/checkpoint.py:21-40, through orbax.checkpoint and
tensorstore's ``ocdbt`` key-value store). Neither package is needed here.

The format, as tensorstore 0.1.80 writes it (integers little-endian,
"varint" LEB128 of at most 64 bits, arrays of n entries stored field by
field):

* every manifest and B+tree node is a file or a part of a data file:
  a magic number (big-endian: ``0x0cdb3a2a`` manifest, ``0x0cdb20de``
  node), the part's length in 8 bytes, a version varint (0), a
  compression varint (0 none, 1 a Zstandard frame of the body), the
  body, and the CRC-32C of everything before it in 4 bytes;
* ``<root>/manifest.ocdbt`` (a single manifest; the numbered kind is
  refused): the config (a 16-byte uuid, the manifest kind, the largest
  inline value and decoded node, the version tree's arity log2 in a byte,
  the compression and, for Zstandard, its level in 4 bytes), then the
  newest versions of the tree: a data file table, their count, and per
  version its generation, root height (a byte), root reference (file,
  offset, length; offset and length 2^64-1 for an empty tree), its key,
  tree and indirect value byte counts and commit time (8 bytes); then the
  references to older versions' nodes, which are not read: the newest
  version is always in the manifest;
* a data file table: the count, each path's prefix shared with the one
  before it, its suffix's length, its base path's length, then the
  suffixes; a file is ``<root>/<base path of the file this table is
  in><base path><rest of the path>``, so a node copied from a process's
  subdirectory (``ocdbt.process_N/``) keeps reading its files there;
* a B+tree node: its height (a byte), a data file table, the entry count,
  each key's prefix shared with the key before it, each key suffix's
  length, for an interior node each entry's prefix length common to its
  subtree, the suffixes; then a leaf's value lengths, kinds (0 inline, 1
  in a data file), the out-of-line values' files and offsets, and the
  inline values one after another; an interior node's children's files,
  offsets and lengths and their key, tree and indirect byte counts. A
  child's keys follow its parent's prefix and the entry's common prefix.

Values in data files carry no checksum of their own: damage there shows
only where the reader of the value checks it (``utils/zarr.py``: the
Zstandard frame and the chunk's size). A part that fails its checksum, a
body that does not decode, a reference past its file's end or a node
that does not parse raises ValueError naming the file; nothing is
returned from it.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1
_HEADER = 12      # the magic and the length; the two varints follow
_MANIFEST_LIMIT = 1 << 26


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the footer of every OCDBT part holds it."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """The fields of one decoded body, each read checked against its end."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def fail(self, why: str):
        raise ValueError(f"{self.where}: {why}")

    def take(self, n: int) -> bytes:
        if n > len(self.data) - self.pos:
            self.fail("the body ends within a field")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            if shift == 63 and b > 1:
                self.fail("a varint above 64 bits")
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def bytes_(self, n: int) -> List[int]:
        return list(self.take(n))

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def end(self) -> None:
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes after the body's "
                      f"fields")


def _safe_path(path: str, where: str) -> str:
    parts = path.split("/")
    if path.startswith("/") or ".." in parts or "\\" in path:
        raise ValueError(f"{where}: a data file path {path!r} outside the "
                         f"store")
    return path


def _file_table(r: _Reader, base: str) -> List[Tuple[str, str]]:
    """(base path, path under the store's root) of each data file of a
    table read in a part whose own file has the base path ``base``."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("a data file path's prefix longer than the path before")
        full = prev[:prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(full):
            r.fail("a data file's base path longer than its path")
        try:
            text = full.decode()
        except UnicodeDecodeError:
            r.fail("a data file path that is not UTF-8")
        own = base + text[:base_len[i]]
        files.append((own, _safe_path(own + text[base_len[i]:], r.where)))
        prev = full
    return files


class OcdbtStore:
    """The newest version of the OCDBT store under ``root``: its keys (str)
    and values (bytes), read on demand. ``height`` is its B+tree's root
    height (0: one leaf node), ``older_versions`` the count of the version
    tree's nodes it does not read. Raises FileNotFoundError without
    ``root/manifest.ocdbt``, ValueError where the store is damaged or of a
    kind not read."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        path = os.path.join(self.root, "manifest.ocdbt")
        with open(path, "rb") as f:
            data = f.read()
        r = _Reader(self._body(data, path, MANIFEST_MAGIC, _MANIFEST_LIMIT),
                    path)
        r.take(16)                                   # uuid
        if r.varint() != 0:
            r.fail("a numbered manifest (only the single kind is read)")
        r.varint()                                   # max inline value bytes
        self.max_node_bytes = r.varint()
        r.byte()                                     # version tree arity
        compression = r.varint()
        if compression == 1:
            r.take(4)                                # Zstandard's level
        elif compression != 0:
            r.fail(f"compression method {compression}")
        files = _file_table(r, "")
        n = r.varint()
        gens, heights = r.varints(n), r.bytes_(n)
        fid, off, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)                             # statistics
        r.u64s(n)                                    # commit times
        m = r.varint()                               # older versions' nodes
        r.varints(m)
        if any(i >= len(files) for i in r.varints(m)):
            r.fail("a version node in no data file")
        r.varints(3 * m)
        r.u64s(m)
        r.bytes_(m)
        r.end()
        if not n:
            r.fail("no version")
        if any(i >= len(files) for i in fid):
            r.fail("a root in no data file")
        v = max(range(n), key=gens.__getitem__)
        self.height, self.older_versions = heights[v], m
        # key -> (the node's file, the inline bytes), or (file, offset,
        # length) of a value in a data file
        self._values: Dict[str, tuple] = {}
        if (off[v], length[v]) != (_MISSING, _MISSING):
            self._walk(files[fid[v]], off[v], length[v], heights[v], b"")

    def _body(self, data: bytes, path: str, magic: int, limit: int) -> bytes:
        """The decoded body of one part, ``data``, read from ``path``."""
        if len(data) < _HEADER + 6:
            raise ValueError(f"{path}: {len(data)} bytes, too few for a "
                             f"part")
        got_magic, size = struct.unpack(">I", data[:4])[0], \
            struct.unpack("<Q", data[4:12])[0]
        if got_magic != magic:
            raise ValueError(f"{path}: magic {got_magic:#010x}, expected "
                             f"{magic:#010x}")
        if size != len(data):
            raise ValueError(f"{path}: a part of {len(data)} bytes that "
                             f"claims {size}")
        if crc32c(data[:-4]) != struct.unpack("<I", data[-4:])[0]:
            raise ValueError(f"{path}: checksum mismatch")
        r = _Reader(data[:-4], path)
        r.pos = _HEADER
        if r.varint() != 0:
            r.fail("a format version other than 0")
        compression = r.varint()
        body = data[r.pos:-4]
        if compression == 0:
            return body
        if compression != 1:
            r.fail(f"compression format {compression}")
        # imported here: the data package imports utils.checkpoint, which
        # imports this module
        from mastermetastyletransfer_tpu_torch.data import native_loader
        try:
            return native_loader.decode_zstd_frame(body, limit)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None

    def _read(self, rel: str, offset: int, length: int) -> Tuple[str, bytes]:
        path = os.path.join(self.root, rel)
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if offset > size or length > size - offset:
                raise ValueError(f"{path}: a reference to bytes [{offset}, "
                                 f"{offset + length}) past the file's end "
                                 f"({size})")
            f.seek(offset)
            return path, f.read(length)

    def _walk(self, file: Tuple[str, str], offset: int, length: int,
              height: int, prefix: bytes) -> None:
        path, data = self._read(file[1], offset, length)
        where = f"{path} [{offset}, {offset + length})"
        r = _Reader(self._body(data, where, BTREE_MAGIC,
                               self.max_node_bytes), where)
        if r.byte() != height:
            r.fail(f"a node of another height than its reference's "
                   f"({height})")
        files = _file_table(r, file[0])
        n = r.varint()
        shared = [0] + r.varints(n - 1) if n else []
        suffix = r.varints(n)
        common = r.varints(n) if height else [0] * n
        keys, prev = [], b""
        for i in range(n):
            if shared[i] > len(prev):
                r.fail("a key's prefix longer than the key before")
            prev = prev[:shared[i]] + r.take(suffix[i])
            if common[i] > len(prev):
                r.fail("a subtree prefix longer than its key")
            keys.append(prev)
        if height:
            fid, off, size = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)                         # statistics
            r.end()
            for i in range(n):
                if fid[i] >= len(files):
                    r.fail("a child in no data file")
                self._walk(files[fid[i]], off[i], size[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        lengths = r.varints(n)
        kinds = r.bytes_(n)
        out = [i for i in range(n) if kinds[i] == 1]
        if any(k > 1 for k in kinds):
            r.fail("a value kind other than inline or in a data file")
        fid, off = r.varints(len(out)), r.varints(len(out))
        refs = dict(zip(out, zip(fid, off)))
        for i in range(n):
            try:
                key = (prefix + keys[i]).decode()
            except UnicodeDecodeError:
                r.fail("a key that is not UTF-8")
            if i in refs:
                f, o = refs[i]
                if f >= len(files):
                    r.fail("a value in no data file")
                self._values[key] = (files[f][1], o, lengths[i])
            else:
                self._values[key] = (where, r.take(lengths[i]))
        r.end()

    def keys(self) -> Iterator[str]:
        return iter(sorted(self._values))

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def where(self, key: str) -> str:
        """The file that holds ``key``'s value, for messages."""
        v = self._values[key]
        if len(v) == 2:
            return f"{v[0]} (the inline value of {key})"
        rel, offset, length = v
        return (f"{os.path.join(self.root, rel)} [{offset}, "
                f"{offset + length}) ({key})")

    def get(self, key: str) -> Optional[bytes]:
        """``key``'s value; None where the store has no such key."""
        v = self._values.get(key)
        if v is None:
            return None
        return v[1] if len(v) == 2 else self._read(*v)[1]
