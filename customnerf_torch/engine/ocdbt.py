"""A read-only reader of OCDBT key-value stores (tensorstore's "optionally
cooperative distributed B+tree", the store under a JAX-written ``.orbax``
checkpoint), without tensorstore.

A store is a directory.  ``manifest.ocdbt`` holds the configuration and the
version tree's newest versions; each version names the root of a B+tree
by (data file, offset, length).  Data files (``d/<hash>`` under the store,
or under ``ocdbt.process_N/`` for the trees an orbax root merges) hold B+tree
nodes and, raw, the values stored out of line.  Every manifest and node is
framed as

    magic u32 big-endian (0x0cdb3a2a manifest, 0x0cdb20de node) ·
    length u64 (the whole frame) · version varint (0) ·
    compression varint (0 none, 1 zstd) · body · CRC-32C u32 of all before

and varints are LEB128.  The manifest body: the config (uuid[16],
manifest kind, max inline value bytes, max decoded node bytes, version tree
arity log2 as a byte, compression method, and for zstd an int32 level),
then the versions columnwise — the data file table, then per version its
generation, root height (byte), root (file id, offset, length), its
statistics (keys, tree bytes, indirect value bytes) and commit time (u64);
then the version tree's interior nodes, which only older versions need.

A data file table: count; for each path after the first the length it
shares with the path before it; each path's remaining length; each path's
base-path length; the remaining bytes.  A path is relative to the store.

A B+tree node body: height (byte); its data file table; the entry count;
the keys prefix-coded the same way (shared lengths, remaining lengths,
then, in an interior node, each child's common key prefix length, then the
key bytes).  A leaf then gives each value's length and kind (0 inline, 1
out of line), the out-of-line values' (file id, offset) columnwise and the
inline values' bytes; an interior node gives each child's (file id, offset,
length) and statistics.  A node's keys follow the prefix its parent gave
it: the parent's prefix and the child's common prefix of the entry key.

Only manifests of the single kind are read (tensorstore's default, which
orbax writes); the newest version is the one read, as tensorstore reads it.
Every frame's length and CRC-32C are checked; a bad frame raises
``ValueError`` naming the file.

:func:`write_store` writes a store of one version in the same format, the
way the port commits a ``.orbax`` checkpoint: one data file holding the
out-of-line values and then the B+tree, whose single leaf node holds every
key (a leaf holds only references to values above ``max_inline_value_bytes``,
so a checkpoint's tree stays a few kB), and the manifest.  Frames are
uncompressed (compression 0), which tensorstore reads as it reads zstd ones.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import uuid
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from customnerf_torch.utils import hostlib, zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1          # the offset of a version without a root


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of a bytes-like object, in the host library."""
    a = np.frombuffer(memoryview(data).cast("B"), np.uint8)
    return int(hostlib.library().cn_crc32c(hostlib.ptr(a), len(a), 0))


class _Cursor:
    def __init__(self, buf: bytes, what: str):
        self.b, self.p, self.what = buf, 0, what

    def _need(self, n):
        if self.p + n > len(self.b):
            raise ValueError(f"{self.what}: truncated")

    def byte(self) -> int:
        self._need(1)
        self.p += 1
        return self.b[self.p - 1]

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            c = self.byte()
            v |= (c & 0x7F) << shift
            if c < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: bad varint")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        self._need(n)
        self.p += n
        return self.b[self.p - n:self.p]

    def u64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]

    def end(self):
        if self.p != len(self.b):
            raise ValueError(f"{self.what}: {len(self.b) - self.p} bytes after its end")


def unframe(buf: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node frame, after checking its magic,
    length, version and CRC-32C (decompressed when it is zstd)."""
    if len(buf) < 18:
        raise ValueError(f"{what}: truncated OCDBT frame")
    got_magic, length = struct.unpack(">I", buf[:4])[0], struct.unpack("<Q", buf[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"{what}: not an OCDBT {'manifest' if magic == MANIFEST_MAGIC else 'node'} "
                         f"(magic {got_magic:#010x})")
    if length != len(buf):
        raise ValueError(f"{what}: OCDBT frame length {length} != {len(buf)} bytes read")
    want = struct.unpack("<I", buf[-4:])[0]
    if crc32c(buf[:-4]) != want:
        raise ValueError(f"{what}: CRC-32C mismatch (corrupt OCDBT frame)")
    c = _Cursor(buf[:-4], what)
    c.p = 12
    version, compression = c.varint(), c.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version} is not supported")
    body = buf[c.p:-4]
    if compression == 1:
        return zstd.decompress(body, what).tobytes()
    if compression != 0:
        raise ValueError(f"{what}: OCDBT compression {compression} is not supported")
    return body


def _prefix_coded(c: _Cursor, n: int, with_subtree_prefix: bool = False):
    """n prefix-coded byte strings (and, in interior nodes, each one's
    subtree common prefix length, which sits before the bytes)."""
    shared = [0] + c.varints(n - 1) if n else []
    rest = c.varints(n)
    subtree = c.varints(n) if with_subtree_prefix else None
    out, prev = [], b""
    for s, r in zip(shared, rest):
        if s > len(prev):
            raise ValueError(f"{c.what}: bad prefix coding")
        prev = prev[:s] + c.raw(r)
        out.append(prev)
    return out, subtree


def _data_file_table(c: _Cursor) -> List[str]:
    n = c.varint()
    shared = [0] + c.varints(n - 1) if n else []
    rest = c.varints(n)
    base = c.varints(n)
    paths, prev = [], b""
    for s, r, b in zip(shared, rest, base):
        if s > len(prev):
            raise ValueError(f"{c.what}: bad data file table")
        prev = prev[:s] + c.raw(r)
        if b > len(prev):
            raise ValueError(f"{c.what}: bad data file table")
        paths.append(prev.decode())
    return paths


class OcdbtStore:
    """The newest version of the OCDBT store at ``root``: its keys in order
    and their values.  Data files stay open until :meth:`close` (or the
    end of a ``with`` block)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(str(root))
        self._fds: Dict[str, int] = {}
        self._lock = threading.Lock()
        what = os.path.join(self.root, "manifest.ocdbt")
        try:
            with open(what, "rb") as fh:
                buf = fh.read()
        except FileNotFoundError:
            raise ValueError(f"{self.root}: no OCDBT manifest (manifest.ocdbt)") from None
        c = _Cursor(unframe(buf, MANIFEST_MAGIC, what), what)
        c.raw(16)                                        # uuid
        kind = c.varint()
        if kind != 0:
            raise ValueError(f"{what}: numbered OCDBT manifests are not supported")
        self.max_inline_value_bytes = c.varint()
        self.max_decoded_node_bytes = c.varint()
        c.byte()                                         # version tree arity log2
        if c.varint() == 1:
            c.raw(4)                                     # zstd level (int32)
        files = _data_file_table(c)
        n = c.varint()
        gens = c.varints(n)
        heights = [c.byte() for _ in range(n)]
        ids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)                                 # statistics
        [c.u64() for _ in range(n)]                      # commit times
        self.generation = gens[-1] if n else 0
        self.versions = n                                # in the manifest's leaf
        self.height = heights[-1] if n else 0            # of the newest B+tree
        # key → inline bytes, or (path, offset, length) of an out-of-line value
        self._entries: Dict[bytes, object] = {}
        if n and offs[-1] != _MISSING:
            self._walk(files, ids[-1], offs[-1], lens[-1], b"", heights[-1])

    def _read_file(self, path: str, offset: int, length: int, what: str) -> bytes:
        """``length`` bytes at ``offset`` of a data file, through one
        descriptor a file kept open (``os.pread``: threads read at once)."""
        fd = self._fds.get(path)
        if fd is None:
            with self._lock:
                fd = self._fds.get(path)
                if fd is None:
                    fd = self._fds[path] = os.open(os.path.join(self.root, path),
                                                   os.O_RDONLY)
        data = os.pread(fd, length, offset)
        if len(data) != length:
            raise ValueError(f"{what}: {os.path.join(self.root, path)} ends before "
                             f"byte {offset + length}")
        return data

    def close(self):
        fds, self._fds = self._fds, {}
        for fd in fds.values():
            os.close(fd)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

    def _walk(self, files, fid, offset, length, prefix: bytes, height: int):
        if fid >= len(files):
            raise ValueError(f"{self.root}: node reference to data file {fid} of {len(files)}")
        what = f"{os.path.join(self.root, files[fid])}@{offset}"
        body = unframe(self._read_file(files[fid], offset, length, what), NODE_MAGIC, what)
        c = _Cursor(body, what)
        h = c.byte()
        if h != height:
            raise ValueError(f"{what}: node height {h}, its parent says {height}")
        node_files = _data_file_table(c)
        n = c.varint()
        if h == 0:
            keys, _ = _prefix_coded(c, n)
            vlen = c.varints(n)
            kind = c.varints(n)
            if any(k > 1 for k in kind):
                raise ValueError(f"{what}: unknown value kind")
            k = sum(kind)
            vids, voffs = c.varints(k), c.varints(k)
            j = 0
            for key, ln, kd in zip(keys, vlen, kind):
                if kd:
                    if vids[j] >= len(node_files):
                        raise ValueError(f"{what}: value in data file {vids[j]} "
                                         f"of {len(node_files)}")
                    self._entries[prefix + key] = (node_files[vids[j]], voffs[j], ln)
                    j += 1
                else:
                    self._entries[prefix + key] = c.raw(ln)
            c.end()
            return
        keys, subtree = _prefix_coded(c, n, with_subtree_prefix=True)
        cids, coffs, clens = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)                                 # statistics
        c.end()
        for key, sp, cid, coff, cln in zip(keys, subtree, cids, coffs, clens):
            if sp > len(key):
                raise ValueError(f"{what}: subtree prefix longer than its key")
            self._walk(node_files, cid, coff, cln, prefix + key[:sp], h - 1)

    def keys(self) -> List[bytes]:
        return sorted(self._entries)

    def __contains__(self, key) -> bool:
        return _key(key) in self._entries

    def read(self, key) -> bytes:
        """The value stored under ``key`` (bytes or str); KeyError when the
        store has none."""
        v = self._entries[_key(key)]
        if isinstance(v, bytes):
            return v
        path, offset, length = v
        return self._read_file(path, offset, length, f"{self.root}:{_key(key)!r}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        for k in self.keys():
            yield k, self.read(k)

    def value_size(self, key) -> Optional[int]:
        v = self._entries.get(_key(key))
        if v is None:
            return None
        return len(v) if isinstance(v, bytes) else v[2]


def _key(key) -> bytes:
    return key.encode() if isinstance(key, str) else bytes(key)


# ------------------------------------------------------------------ writing
MAX_INLINE_VALUE_BYTES = 1024           # tensorstore's defaults, as orbax writes them
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def frame(body: bytes, magic: int) -> bytes:
    """An uncompressed manifest or node frame around ``body``."""
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + 2 + len(body) + 4) + b"\0\0"
    buf = head + body
    return buf + struct.pack("<I", crc32c(buf))


def _encode_data_file_table(paths: Sequence[str]) -> bytes:
    """Each path whole, with an empty base path (as tensorstore writes a
    store's own files)."""
    raw = [p.encode() for p in paths]
    shared = [0] + [_common(a, b) for a, b in zip(raw, raw[1:])]
    return (_varint(len(raw)) + _varints(shared[1:])
            + _varints(len(r) - s for r, s in zip(raw, shared))
            + _varints(0 for _ in raw)
            + b"".join(r[s:] for r, s in zip(raw, shared)))


def _common(a: bytes, b: bytes) -> int:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def write_store(root: str, entries) -> int:
    """Write ``entries`` (key → bytes-like value; keys str or bytes) as a
    new OCDBT store at ``root`` and return the bytes written.  Values above
    ``MAX_INLINE_VALUE_BYTES`` go out of line into ``d/<uuid>`` (written
    from their buffers, without a copy), followed there by the leaf node;
    ``manifest.ocdbt`` names it.  Each file is fsynced, as tensorstore's
    file store syncs its writes."""
    items = sorted((_key(k), memoryview(v).cast("B")) for k, v in entries.items())
    keys = [k for k, _ in items]
    if len(set(keys)) != len(keys):
        raise ValueError(f"{root}: duplicate keys")
    if not keys:
        raise ValueError(f"{root}: an OCDBT store needs at least one key")
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    data_name = f"d/{uuid.uuid4().hex}"
    offsets: List[Optional[int]] = []
    written = 0
    with open(os.path.join(root, data_name), "wb") as fh:
        for _, v in items:
            if len(v) > MAX_INLINE_VALUE_BYTES:
                offsets.append(written)
                fh.write(v)
                written += len(v)
            else:
                offsets.append(None)
        indirect = written
        ool = [i for i, o in enumerate(offsets) if o is not None]
        shared = [0] + [_common(a, b) for a, b in zip(keys, keys[1:])]
        body = b"".join([
            b"\0",                                             # height
            _encode_data_file_table([data_name] if ool else []),
            _varint(len(keys)),
            _varints(shared[1:]),
            _varints(len(k) - s for k, s in zip(keys, shared)),
            b"".join(k[s:] for k, s in zip(keys, shared)),
            _varints(len(v) for _, v in items),
            _varints(int(o is not None) for o in offsets),
            _varints(0 for _ in ool),
            _varints(offsets[i] for i in ool),
            b"".join(bytes(v) for (_, v), o in zip(items, offsets) if o is None)])
        if len(body) > MAX_DECODED_NODE_BYTES:
            raise ValueError(f"{root}: a leaf node of {len(body)} bytes is above "
                             f"max_decoded_node_bytes ({MAX_DECODED_NODE_BYTES})")
        node = frame(body, NODE_MAGIC)
        node_offset = written
        fh.write(node)
        written += len(node)
        fh.flush()
        os.fsync(fh.fileno())
    manifest = frame(b"".join([
        uuid.uuid4().bytes,
        _varint(0),                                             # single manifest
        _varint(MAX_INLINE_VALUE_BYTES),
        _varint(MAX_DECODED_NODE_BYTES),
        bytes([VERSION_TREE_ARITY_LOG2]),
        _varint(0),                                             # no compression
        _encode_data_file_table([data_name]),
        _varint(1),                                             # one version
        _varint(1),                                             # generation 1
        b"\0",                                                 # root height
        _varints([0, node_offset, len(node)]),
        _varints([len(keys), len(node), indirect]),             # statistics
        struct.pack("<Q", time.time_ns()),                      # commit time
        _varint(0)]), MANIFEST_MAGIC)                           # no version nodes
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as fh:
        fh.write(manifest)
        fh.flush()
        os.fsync(fh.fileno())
    return written + len(manifest)
