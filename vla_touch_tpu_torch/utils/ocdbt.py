"""Tensorstore's OCDBT key-value database, as orbax writes it (``use_ocdbt``):
a reader and a one-version writer on the standard library and numpy.

Layout (read off the bytes tensorstore writes; its kvstore API is the oracle
of ``tests/test_torch_orbax.py``).  Every manifest, B+tree node and version
tree node is one encoded unit::

    magic       u32 big-endian   0x0cdb3a2a manifest, 0x0cdb20de B+tree node,
                                 0x0cdb1234 version tree node
    length      u64 little-endian, the unit's bytes (header and footer too)
    version     varint 0
    compression varint 0 raw | 1 zstd (one frame)
    body
    crc32c      u32 little-endian, CRC-32C of every byte before it

``manifest.ocdbt`` (manifest kind 0, single: orbax's, and what the writer
writes) holds one unit: the config (uuid[16], manifest kind,
max_inline_value_bytes, max_decoded_node_bytes, version_tree_arity_log2
u8, compression: varint method, zstd level i32 LE), a data-file table, the
newest versions inline (columns: generation, root height, file id, offset,
length, num_keys, num_tree_bytes, num_indirect_value_bytes, commit time
u64 LE) and version tree node references (generation, file id, offset,
length, num_generations, commit time, height).  A data-file table is
num_files, then prefix lengths (one per file after the first), suffix
lengths and base-path lengths, then the suffixes: each path is the
previous one's prefix plus its suffix, relative to the database's root;
its first base-path-length bytes are its base path (``ocdbt.process_N/``
in orbax's merged root, where the other databases' data files are named).  B+tree node
body: height u8, a data-file table, num_entries, key prefix lengths (after
the first), key suffix lengths, [interior: subtree common prefix lengths],
the key suffixes, then a leaf's value lengths, kinds (0 inline, 1 in a data
file), the out-of-line values' file ids and offsets and the inline bytes,
or an interior node's children (file id, offset, length, num_keys,
num_tree_bytes, num_indirect_value_bytes).  A child's keys are relative to
its entry key's first ``subtree_common_prefix_length`` bytes.  Version
tree node body: arity_log2 u8, height u8, a data-file table, num_entries,
then version columns (leaf) or node references without height (interior).
Out-of-line values lie raw in the data files (``d/<32 hex>``), beside the
nodes.  Manifest kind 1 (numbered): ``manifest.ocdbt`` holds the config
alone, and each commit writes ``manifest.<generation, 16 hex digits>``, a
whole manifest unit as above; the reader takes the highest-numbered one
that decodes.

A multi-process orbax checkpoint is one database per process
(``ocdbt.process_<i>/``, each written alone) and a root database that
joins them (:func:`join`): one B+tree over every process's keys, whose
inline values are copies and whose out-of-line values are references into
the processes' data files, with base path ``ocdbt.process_<i>/``, as
tensorstore's merge leaves them.
"""

from __future__ import annotations

import os
import re
import struct
import threading
import time
import uuid as uuid_lib
from collections.abc import Mapping
from typing import Iterator, Optional

from vla_touch_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
MANIFEST_NAME = "manifest.ocdbt"
MANIFEST_SINGLE, MANIFEST_NUMBERED = 0, 1   # the config's manifest kinds
_NUMBERED = re.compile(r"manifest\.[0-9a-f]{16}")
NO_OFFSET = (1 << 64) - 1
# the writer's config: orbax's (its `ocdbt` kvstore spec; zstd level 0 is
# zstd's default, as tensorstore writes it)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
ZSTD_LEVEL = 0
# the writer closes a data file once it passes this many bytes
DATA_FILE_BYTES = 1 << 31


# ---- CRC-32C (Castagnoli), table driven -------------------------------------

def _crc_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data) -> int:
    crc = 0xFFFFFFFF
    t = _CRC_TABLE
    for b in bytes(data):
        crc = t[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---- varints and the encoded unit --------------------------------------------


class FormatError(ValueError):
    """A file that is not what the format says (names the file)."""


class _In:
    def __init__(self, data, what: str):
        self.d = memoryview(data).cast("B")
        self.pos = 0
        self.what = what

    def fail(self, msg: str):
        raise FormatError(f"{self.what}: {msg} (at byte {self.pos} of the body)")

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.d):
            self.fail(f"truncated: {n} bytes wanted")
        b = self.d[self.pos:self.pos + n]
        self.pos += n
        return b

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            b = self.byte()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def end(self):
        if self.pos != len(self.d):
            self.fail(f"{len(self.d) - self.pos} trailing bytes")


def _varint(v: int, out: bytearray) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _varints(vs, out: bytearray) -> None:
    for v in vs:
        _varint(v, out)


def decode_unit(data, magic: int, what: str) -> memoryview:
    """The body of one encoded unit (header, CRC-32C and magic checked)."""
    data = memoryview(data).cast("B")
    if len(data) < 18:
        raise FormatError(f"{what}: {len(data)} bytes is too short")
    got_magic, length = struct.unpack(">I", data[:4])[0], struct.unpack("<Q", data[4:12])[0]
    if got_magic != magic:
        raise FormatError(f"{what}: magic 0x{got_magic:08x}, expected 0x{magic:08x}")
    if length != len(data):
        raise FormatError(f"{what}: header says {length} bytes, read {len(data)}")
    want = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != want:
        raise FormatError(f"{what}: CRC-32C mismatch")
    head = _In(data[12:-4], what)
    if head.varint() != 0:
        head.fail("unknown format version")
    method = head.varint()
    payload = data[12 + head.pos:-4]
    if method == 0:
        return payload
    if method == 1:
        return memoryview(zstd.decompress(payload, reading=what))
    head.fail(f"unknown compression {method}")


def encode_unit(body: bytes, magic: int, level: Optional[int]) -> bytes:
    """``body`` as one unit (zstd at ``level``; raw when None)."""
    head = bytearray(struct.pack(">I", magic) + b"\0" * 8)
    _varint(0, head)
    _varint(0 if level is None else 1, head)
    payload = body if level is None else zstd.compress(body, level)
    out = head + payload + b"\0" * 4
    out[4:12] = struct.pack("<Q", len(out))
    out[-4:] = struct.pack("<I", crc32c(out[:-4]))
    return bytes(out)


# ---- shared pieces of the bodies ---------------------------------------------


def _read_file_table(r: _In) -> list:
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for p, s, b in zip(prefix, suffix, base):
        if p > len(prev):
            r.fail("data-file path prefix longer than the previous path")
        full = prev[:p] + bytes(r.take(s))
        if b > len(full):
            r.fail("data-file base path longer than its path")
        paths.append(full.decode("utf-8"))
        prev = full
    return paths


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _write_file_table(paths: list, out: bytearray, bases: Optional[Mapping] = None) -> None:
    """Paths relative to the root; ``bases``: path -> its base path's
    length (0 where absent)."""
    enc = [p.encode("utf-8") for p in paths]
    _varint(len(enc), out)
    if not enc:
        return
    prefix = [_common(a, b) for a, b in zip(enc, enc[1:])]
    _varints(prefix, out)
    _varints([len(e) - p for e, p in zip(enc, [0] + prefix)], out)
    _varints([(bases or {}).get(p, 0) for p in paths], out)
    for e, p in zip(enc, [0] + prefix):
        out += e[p:]


def _read_keys(r: _In, n: int, interior: bool) -> tuple:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    subtree = r.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            r.fail("key prefix longer than the previous key")
        prev = prev[:p] + bytes(r.take(s))
        keys.append(prev)
    return keys, subtree


def _write_keys(keys: list, out: bytearray, subtree: Optional[list] = None) -> None:
    _varint(len(keys), out)
    prefix = [_common(a, b) for a, b in zip(keys, keys[1:])]
    _varints(prefix, out)
    _varints([len(k) - p for k, p in zip(keys, [0] + prefix)], out)
    if subtree is not None:
        _varints(subtree, out)
    for k, p in zip(keys, [0] + prefix):
        out += k[p:]


def _file_of(r: _In, files: list, i: int) -> str:
    if i >= len(files):
        r.fail(f"data file id {i} outside the table of {len(files)}")
    return files[i]


# ---- reader ----------------------------------------------------------------------


class Database(Mapping):
    """A read-only mapping key bytes -> value bytes of the newest version of
    the database at ``root``.  The keys are read when it opens; values are
    read from their files on access (``os.pread``; safe across threads).
    Use as a context manager, or call :meth:`close`."""

    def __init__(self, root: str):
        self.root = root
        self._fds: dict = {}
        self._lock = threading.Lock()
        path = os.path.join(root, MANIFEST_NAME)
        with open(path, "rb") as f:
            r = _In(decode_unit(f.read(), MANIFEST_MAGIC, path), path)
        self.manifest_kind = self._read_config(r)
        if self.manifest_kind == MANIFEST_NUMBERED:
            # manifest.ocdbt holds the config alone; the versions are in the
            # newest numbered manifest that decodes
            r.end()
            r = self._numbered_manifest()
            if r is None:                        # no commit yet: empty
                self.generation, self.height, self._index = 0, 0, {}
                return
            self._read_config(r)
        elif self.manifest_kind != MANIFEST_SINGLE:
            r.fail(f"unknown manifest kind {self.manifest_kind}")
        files = _read_file_table(r)
        versions = self._read_versions(r, files)
        nodes = self._read_version_refs(r, files, with_height=True)
        r.end()
        self.generation, root_ref = self._newest(versions, nodes)
        # the B+tree's height: 0 is one leaf
        self.height = root_ref[3] if root_ref is not None else 0
        # key -> (inline bytes) or (file, offset, length)
        self._index: dict = {}
        if root_ref is not None:
            self._walk(*root_ref, prefix=b"")

    def _read_config(self, r: _In) -> int:
        """The config at the start of a manifest; returns its manifest kind."""
        self.uuid = bytes(r.take(16))
        kind = r.varint()
        self.max_inline_value_bytes = r.varint()
        self.max_decoded_node_bytes = r.varint()
        self.version_tree_arity_log2 = r.byte()
        method = r.varint()
        self.compression_level = struct.unpack("<i", r.take(4))[0] if method == 1 else None
        if method not in (0, 1):
            r.fail(f"unknown compression method {method}")
        return kind

    def _numbered_manifest(self) -> Optional[_In]:
        """The highest-numbered ``manifest.<16 hex digits>`` of the root that
        decodes (a reader can meet a newer one half written), or None when
        there is none."""
        names = sorted((n for n in os.listdir(self.root) if _NUMBERED.fullmatch(n)),
                       reverse=True)
        for name in names:
            path = os.path.join(self.root, name)
            with open(path, "rb") as f:
                data = f.read()
            try:
                return _In(decode_unit(data, MANIFEST_MAGIC, path), path)
            except FormatError:
                if name == names[-1]:
                    raise
        return None

    # -- version tree --

    @staticmethod
    def _read_versions(r: _In, files: list) -> list:
        n = r.varint()
        gen, height, fid = r.varints(n), [r.byte() for _ in range(n)], r.varints(n)
        off, length = r.varints(n), r.varints(n)
        r.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
        [r.u64() for _ in range(n)]  # commit times
        return [(g, None if o == NO_OFFSET else (_file_of(r, files, f), o, ln, h))
                for g, h, f, o, ln in zip(gen, height, fid, off, length)]

    @staticmethod
    def _read_version_refs(r: _In, files: list, with_height: bool,
                           height: int = 0) -> list:
        n = r.varint()
        gen, fid, off, length = r.varints(n), r.varints(n), r.varints(n), r.varints(n)
        r.varints(n)  # num_generations
        [r.u64() for _ in range(n)]
        heights = [r.byte() for _ in range(n)] if with_height else [height] * n
        return [(g, (_file_of(r, files, f), o, ln), h)
                for g, f, o, ln, h in zip(gen, fid, off, length, heights)]

    def _newest(self, versions: list, nodes: list):
        best = max([(g, "v", ref) for g, ref in versions]
                   + [(g, "n", (ref, h)) for g, ref, h in nodes],
                   key=lambda x: x[0], default=None)
        while best is not None and best[1] == "n":
            (path, off, length), height = best[2]
            what = f"{os.path.join(self.root, path)}@{off}"
            r = _In(decode_unit(self._read(path, off, length), VERSION_MAGIC, what), what)
            r.byte()  # arity
            if r.byte() != height:
                r.fail(f"version node height differs from its reference's {height}")
            files = _read_file_table(r)
            if height == 0:
                entries = [(g, "v", ref) for g, ref in self._read_versions(r, files)]
            else:
                entries = [(g, "n", (ref, h)) for g, ref, h in
                           self._read_version_refs(r, files, False, height - 1)]
            r.end()
            best = max(entries, key=lambda x: x[0], default=None)
        if best is None:
            return 0, None
        return best[0], best[2]

    # -- B+tree --

    def _walk(self, path: str, off: int, length: int, height: int, prefix: bytes):
        what = f"{os.path.join(self.root, path)}@{off}"
        r = _In(decode_unit(self._read(path, off, length), BTREE_MAGIC, what), what)
        if r.byte() != height:
            r.fail(f"B+tree node height differs from its reference's {height}")
        files = _read_file_table(r)
        n = r.varint()
        keys, subtree = _read_keys(r, n, interior=height > 0)
        if height > 0:
            fid, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)
            r.end()
            for k, s, f, o, ln in zip(keys, subtree, fid, offs, lens):
                self._walk(_file_of(r, files, f), o, ln, height - 1, prefix + k[:s])
            return
        lens = r.varints(n)
        kinds = r.varints(n)
        if any(k not in (0, 1) for k in kinds):
            r.fail("unknown value kind")
        m = sum(kinds)
        fid, offs = r.varints(m), r.varints(m)
        ind = iter(zip(fid, offs))
        for k, kind, ln in zip(keys, kinds, lens):
            if kind:
                f, o = next(ind)
                self._index[prefix + k] = (_file_of(r, files, f), o, ln)
            else:
                self._index[prefix + k] = bytes(r.take(ln))
        r.end()

    # -- files --

    def _fd(self, path: str) -> int:
        with self._lock:
            fd = self._fds.get(path)
            if fd is None:
                fd = self._fds[path] = os.open(os.path.join(self.root, path), os.O_RDONLY)
            return fd

    def _read(self, path: str, off: int, length: int) -> bytes:
        data = os.pread(self._fd(path), length, off)
        if len(data) != length:
            raise FormatError(f"{os.path.join(self.root, path)}: {length} bytes at "
                              f"{off} wanted, the file ends after {len(data)}")
        return data

    # -- Mapping --

    def __getitem__(self, key: bytes) -> bytes:
        ref = self._index[key]
        return ref if isinstance(ref, bytes) else self._read(*ref)

    def __iter__(self) -> Iterator[bytes]:
        return iter(sorted(self._index))

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, key) -> bool:
        return key in self._index

    def entries(self) -> Iterator[tuple]:
        """(key, value) of every key, the value as stored: the inline bytes,
        or (data file relative to the root, offset, length)."""
        return iter(self._index.items())

    def close(self) -> None:
        with self._lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---- writer ----------------------------------------------------------------------


class Writer:
    """Writes one database of one version at ``root`` (a new directory),
    with the module's config constants.

    ``put`` values in any order from one thread: a value above
    :data:`MAX_INLINE_VALUE_BYTES` goes at once, raw, to the open data file
    (``d/<32 hex>``, a new one past :data:`DATA_FILE_BYTES`); the rest stay
    in memory for the leaves.  ``put_ref`` enters a value that already lies
    in another database's data file under the root.  :meth:`commit` writes the B+tree (one leaf,
    or leaves of at most :data:`MAX_DECODED_NODE_BYTES` under interior
    nodes), zstd-compressed, then ``manifest.ocdbt``, and returns the bytes
    written."""

    def __init__(self, root: str):
        self.root = root
        self.max_inline = MAX_INLINE_VALUE_BYTES
        self.max_node = MAX_DECODED_NODE_BYTES
        self.data_file_bytes = DATA_FILE_BYTES
        os.makedirs(os.path.join(root, "d"), exist_ok=True)
        self._entries: dict = {}
        # data file -> the length of its base path (put_ref's files)
        self._bases: dict = {}
        self._file = None
        self._path = None
        self._pos = 0
        self.bytes_written = 0

    def _new_file(self) -> None:
        self._close_file()
        self._path = f"d/{uuid_lib.uuid4().hex}"
        self._file = open(os.path.join(self.root, self._path), "wb")
        self._pos = 0

    def _close_file(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def _append(self, data) -> tuple:
        if self._file is None or self._pos >= self.data_file_bytes:
            self._new_file()
        off = self._pos
        n = self._file.write(data)
        self._pos += n
        self.bytes_written += n
        return self._path, off, n

    def put(self, key: bytes, value) -> None:
        if key in self._entries:
            raise KeyError(f"{key!r} put twice")
        n = memoryview(value).nbytes
        self._entries[key] = (self._append(value) if n > self.max_inline
                              else bytes(value))

    def put_ref(self, key: bytes, base: str, path: str, offset: int, length: int) -> None:
        """``key``'s value: ``length`` bytes at ``offset`` of the data file
        ``base + path`` (relative to the root; ``base`` is its base path,
        e.g. ``ocdbt.process_1/``), left where it is."""
        if key in self._entries:
            raise KeyError(f"{key!r} put twice")
        self._entries[key] = (base + path, offset, length)
        self._bases[base + path] = len(base)

    def commit(self) -> int:
        try:
            keys = sorted(self._entries)
            if keys:
                leaves = self._split(keys)
                refs = [self._write_leaf(part) for part in leaves]
                height = 0
                while len(refs) > 1:
                    refs = [self._write_interior(group) for group in self._group(refs)]
                    height += 1
                root = refs[0]
            else:
                root, height = None, 0
            self._close_file()
            self._write_manifest(root, height)
            return self.bytes_written
        finally:
            self._close_file()

    # -- nodes --

    def _leaf_cost(self, key: bytes) -> int:
        """An upper bound of one entry's share of a decoded leaf."""
        v = self._entries[key]
        return len(key) + 40 + (len(v) if isinstance(v, bytes) else 0)

    def _split(self, keys: list) -> list:
        parts, cur, size = [], [], 64
        for k in keys:
            c = self._leaf_cost(k)
            if cur and size + c > self.max_node:
                parts.append(cur)
                cur, size = [], 64
            cur.append(k)
            size += c
        parts.append(cur)
        return parts

    def _group(self, refs: list) -> list:
        groups, cur, size = [], [], 64
        for ref in refs:
            c = len(ref["key"]) + 80
            if cur and size + c > self.max_node:
                groups.append(cur)
                cur, size = [], 64
            cur.append(ref)
            size += c
        groups.append(cur)
        return groups

    def _write_node(self, body: bytes) -> tuple:
        if len(body) > self.max_node:
            raise ValueError(f"a B+tree node of {len(body)} bytes passes "
                             f"max_decoded_node_bytes {self.max_node}")
        return self._append(encode_unit(body, BTREE_MAGIC, ZSTD_LEVEL))

    def _write_leaf(self, keys: list) -> dict:
        vals = [self._entries[k] for k in keys]
        files = sorted({v[0] for v in vals if isinstance(v, tuple)})
        fid = {p: i for i, p in enumerate(files)}
        body = bytearray([0])
        _write_file_table(files, body, self._bases)
        _write_keys(keys, body)
        _varints([len(v) if isinstance(v, bytes) else v[2] for v in vals], body)
        _varints([0 if isinstance(v, bytes) else 1 for v in vals], body)
        ind = [v for v in vals if isinstance(v, tuple)]
        _varints([fid[v[0]] for v in ind], body)
        _varints([v[1] for v in ind], body)
        for v in vals:
            if isinstance(v, bytes):
                body += v
        path, off, n = self._write_node(bytes(body))
        return {"key": keys[0], "path": path, "off": off, "len": n, "keys": len(keys),
                "tree": n, "indirect": sum(v[2] for v in ind)}

    def _write_interior(self, refs: list) -> dict:
        files = sorted({r["path"] for r in refs})
        fid = {p: i for i, p in enumerate(files)}
        body = bytearray([refs[0].get("height", 0) + 1])
        _write_file_table(files, body)
        # children hold full keys: no common prefix is stripped
        _write_keys([r["key"] for r in refs], body, subtree=[0] * len(refs))
        for col in ([fid[r["path"]] for r in refs], [r["off"] for r in refs],
                    [r["len"] for r in refs], [r["keys"] for r in refs],
                    [r["tree"] for r in refs], [r["indirect"] for r in refs]):
            _varints(col, body)
        path, off, n = self._write_node(bytes(body))
        return {"key": refs[0]["key"], "path": path, "off": off, "len": n,
                "keys": sum(r["keys"] for r in refs),
                "tree": n + sum(r["tree"] for r in refs),
                "indirect": sum(r["indirect"] for r in refs),
                "height": refs[0].get("height", 0) + 1}

    def _write_manifest(self, root: Optional[dict], height: int) -> None:
        body = bytearray(uuid_lib.uuid4().bytes)
        _varint(MANIFEST_SINGLE, body)
        _varint(self.max_inline, body)
        _varint(self.max_node, body)
        body.append(VERSION_TREE_ARITY_LOG2)
        _varint(1, body)
        body += struct.pack("<i", ZSTD_LEVEL)
        files = [root["path"]] if root else [""]
        _write_file_table(files, body)
        _varint(1, body)  # one version: generation 1
        _varint(1, body)
        body.append(height)
        _varint(0, body)
        if root:
            _varints([root["off"], root["len"], root["keys"], root["tree"],
                      root["indirect"]], body)
        else:
            _varints([NO_OFFSET, NO_OFFSET, 0, 0, 0], body)
        body += struct.pack("<Q", time.time_ns())
        _varint(0, body)  # no version tree nodes
        data = encode_unit(bytes(body), MANIFEST_MAGIC, ZSTD_LEVEL)
        with open(os.path.join(self.root, MANIFEST_NAME), "wb") as f:
            f.write(data)
        self.bytes_written += len(data)


def join(root: str, parts: list) -> int:
    """Write at ``root`` the database that joins the databases in its
    subdirectories ``parts`` (names such as ``ocdbt.process_0``): every key
    of every part, inline values copied, out-of-line values referred to
    where they lie (base path ``<part>/``).  A key in two parts raises.
    Returns the bytes written."""
    w = Writer(root)
    for part in parts:
        with Database(os.path.join(root, part)) as db:
            for key, value in db.entries():
                if isinstance(value, bytes):
                    w.put(key, value)
                else:
                    w.put_ref(key, part + "/", *value)
    return w.commit()
