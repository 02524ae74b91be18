"""Read the JAX package's Orbax checkpoints, without Orbax or tensorstore.

The JAX package saves every train state with ``orbax.checkpoint.
StandardCheckpointer`` (``utils/checkpoint.py`` there). A checkpoint
directory holds:

- ``_CHECKPOINT_METADATA`` (JSON; its presence marks the directory);
- ``_METADATA`` (JSON): each leaf's tree path, a list of keys with
  ``key_type`` 2 for a dict key and 1 for a sequence index, and its
  ``value_type``: ``np.ndarray`` for an array, ``Dict``/``List``/``Tuple``/
  ``None`` for an empty node;
- an OCDBT key-value store: ``manifest.ocdbt`` and data files ``d/<hash>``
  (at the root and under ``ocdbt.process_N/``). OCDBT is tensorstore's
  B+tree format: a manifest lists the versions and the data files; each
  version points at a root node; interior nodes point at children, leaf
  nodes hold each key's value inline or as a (data file, offset, length)
  reference. Every manifest and node file is ``magic (u32 BE), length
  (u64), version (varint), compression (varint: 0 none, 1 zstd), body,
  CRC32C (u32)``; integers in a body are little-endian varints, and the
  tables are stored column by column;
- one zarr v2 array per leaf in that store: the key ``<path>/.zarray``
  (JSON) and one key per chunk, ``<path>/<i.j.k>``, each a zstd frame,
  where ``<path>`` is the leaf's keys joined by ``.``.

:func:`read_orbax` returns the tree: dicts, lists, tuples, ``None``, numpy
arrays, and ``torch.bfloat16`` tensors for bfloat16 leaves (numpy has no
bfloat16). Zstd frames and the CRC32C are decoded by ``csrc/zstd_decode.cpp``,
compiled at first use with the host C++ compiler into ``build/zstd_decode/``
at the root of the checkout, keyed by the SHA-256 of the source, and bound
through ctypes. There is no fallback: a failed build or load, a corrupt
file and any layout this reader does not know (zarr v3, a checkpoint without
OCDBT, a numbered manifest, another compressor, filters, an unknown value
type) raise naming the case.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "zstd_decode.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "zstd_decode")
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_ABI_VERSION = 1  # irtpu_zstd_abi_version() in zstd_decode.cpp

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1  # a version whose tree is empty
_DST_TOO_SMALL, _UNKNOWN_SIZE = -2, -7
_MAX_UNDECLARED = 1 << 34  # the most a frame that declares no size may decode to

# zarr v2 dtype strings; bfloat16 leaves come back as torch.bfloat16
_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<f2": np.float16, "<i4": np.int32,
           "<i8": np.int64, "<u4": np.uint32, "|u1": np.uint8, "|i1": np.int8,
           "|b1": np.bool_, "bfloat16": np.uint16}
# orbax's empty-node value types
_EMPTY = {"Dict": dict, "List": list, "Tuple": tuple, "None": lambda: None}


class OrbaxFormatError(ValueError):
    """A file that is corrupt, or a layout this reader does not decode."""


_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """Where ``csrc/zstd_decode.cpp`` builds to, keyed by its contents."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libirtpu_zstd-{digest}.so")


def _build(out: str) -> None:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("reading an Orbax checkpoint builds csrc/zstd_decode.cpp, which needs "
                           "a host C++ compiler (c++ or g++ on PATH, or $CXX)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, SOURCE], capture_output=True,
                              text=True, timeout=300)
        msg = proc.stderr if proc.returncode else None
    except (OSError, subprocess.SubprocessError) as e:
        msg = str(e)
    if msg is not None:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building {SOURCE} with {cxx} failed:\n{msg}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file


def _lib() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        if lib.irtpu_zstd_abi_version() != _ABI_VERSION:
            raise RuntimeError(f"{so}: ABI version {lib.irtpu_zstd_abi_version()}, "
                               f"expected {_ABI_VERSION}")
        sz, p, i64 = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int64
        lib.irtpu_zstd_decompress.argtypes = [p, sz, p, sz]
        lib.irtpu_zstd_decompress.restype = i64
        lib.irtpu_zstd_content_size.argtypes = [p, sz]
        lib.irtpu_zstd_content_size.restype = i64
        lib.irtpu_zstd_error_name.argtypes = [i64]
        lib.irtpu_zstd_error_name.restype = ctypes.c_char_p
        lib.irtpu_crc32c.argtypes = [p, sz]
        lib.irtpu_crc32c.restype = ctypes.c_uint32
        _LIB = lib
        return lib


def _u8(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8)


def zstd_decompress(data, size: Optional[int] = None) -> np.ndarray:
    """Decode the zstd frames in ``data`` (bytes-like) to a uint8 array.

    With ``size`` the output must be exactly that long. Without it, the
    frames' declared content size is used; where a frame declares none the
    output buffer grows up to ``_MAX_UNDECLARED`` bytes."""
    lib = _lib()
    src = _u8(data)
    sp = src.ctypes.data
    exact = size is not None
    if size is None:
        size = lib.irtpu_zstd_content_size(sp, src.size)
        if size == _UNKNOWN_SIZE:
            exact = False
            size = max(4 * src.size, 1 << 16)
        elif size < 0:
            raise OrbaxFormatError(lib.irtpu_zstd_error_name(size).decode())
        else:
            exact = True
    while True:
        out = np.empty(size, np.uint8)
        r = lib.irtpu_zstd_decompress(sp, src.size, out.ctypes.data, size)
        if r == _DST_TOO_SMALL and not exact and size < _MAX_UNDECLARED:
            size = min(2 * size, _MAX_UNDECLARED)
            continue
        if r < 0:
            raise OrbaxFormatError(lib.irtpu_zstd_error_name(r).decode())
        if exact and r != size:
            raise OrbaxFormatError(f"zstd data decodes to {r} bytes, expected {size}")
        return out[:r]


def crc32c(data) -> int:
    """CRC32C (Castagnoli) of a bytes-like object."""
    src = _u8(data)
    return int(_lib().irtpu_crc32c(src.ctypes.data, src.size))


# ------------------------------------------------------------------ OCDBT
class _Cursor:
    """Reads the little-endian fields of an OCDBT body."""

    def __init__(self, buf, what: str):
        self.b = memoryview(buf).cast("B")
        self.i = 0
        self.what = what

    def _need(self, n: int) -> None:
        if self.i + n > len(self.b):
            raise OrbaxFormatError(f"{self.what}: truncated")

    def varint(self) -> int:
        v = shift = 0
        while True:
            self._need(1)
            c = self.b[self.i]
            self.i += 1
            v |= (c & 0x7F) << shift
            if not c & 0x80:
                return v
            shift += 7
            if shift >= 64:
                raise OrbaxFormatError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8s(self, n: int) -> List[int]:
        self._need(n)
        out = list(self.b[self.i:self.i + n])
        self.i += n
        return out

    def take(self, n: int) -> memoryview:
        self._need(n)
        out = self.b[self.i:self.i + n]
        self.i += n
        return out

    def done(self) -> None:
        if self.i != len(self.b):
            raise OrbaxFormatError(f"{self.what}: {len(self.b) - self.i} bytes left over")


def _prefixed_strings(c: _Cursor, n: int, lengths: bool = False):
    """``n`` front-coded strings: prefix lengths (each against the string
    before), suffix lengths, [a column of lengths into each string,] then
    the suffixes. Returns the strings and that column (or None)."""
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    column = c.varints(n) if lengths else None
    out: List[bytes] = []
    prev = b""
    for i, (p, s) in enumerate(zip(prefix, suffix)):
        if p > len(prev):
            raise OrbaxFormatError(f"{c.what}: prefix longer than the string before it")
        prev = prev[:p] + bytes(c.take(s))
        if column is not None and column[i] > len(prev):
            raise OrbaxFormatError(f"{c.what}: a prefix length past its string")
        out.append(prev)
    return out, column


def _data_file_table(c: _Cursor) -> List[str]:
    """The data file table: its paths (each with the length of its base
    path, unused here), relative to the store's root."""
    paths, _ = _prefixed_strings(c, c.varint(), lengths=True)
    out = [p.decode() for p in paths]
    for path in out:
        if path.startswith("/") or ".." in path.split("/"):
            raise OrbaxFormatError(f"{c.what}: data file path {path!r} leaves the store")
    return out


def _file_body(raw, magic: int, what: str) -> bytes:
    """The body of an OCDBT manifest or node file, its header, length and
    CRC32C checked and its compression undone."""
    raw = memoryview(raw)
    if len(raw) < 18:
        raise OrbaxFormatError(f"{what}: truncated")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise OrbaxFormatError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise OrbaxFormatError(f"{what}: length field does not match the file")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise OrbaxFormatError(f"{what}: CRC32C mismatch (corrupt file)")
    c = _Cursor(raw[:-4], what)
    c.i = 12
    version = c.varint()
    if version != 0:
        raise OrbaxFormatError(f"{what}: OCDBT format version {version} is not supported")
    comp = c.varint()
    body = raw[c.i:-4]
    if comp == 0:
        return bytes(body)
    if comp == 1:
        return zstd_decompress(body).tobytes()
    raise OrbaxFormatError(f"{what}: unknown OCDBT compression {comp}")


class OcdbtStore:
    """The newest version of an OCDBT store in a directory, read only."""

    def __init__(self, root: str):
        self.root = root
        self._files: Dict[str, Any] = {}
        path = os.path.join(root, "manifest.ocdbt")
        if not os.path.exists(path):
            if any(f.startswith("manifest.") for f in os.listdir(root)):
                raise OrbaxFormatError(f"{root}: a numbered OCDBT manifest is not supported")
            raise OrbaxFormatError(f"{root}: no manifest.ocdbt (not an OCDBT store)")
        with open(path, "rb") as f:
            raw = f.read()
        c = _Cursor(_file_body(raw, MANIFEST_MAGIC, path), path)
        c.take(16)  # uuid
        if c.varint() != 0:
            raise OrbaxFormatError(f"{path}: a numbered OCDBT manifest is not supported")
        c.varints(2)  # max inline value bytes, max decoded node bytes
        c.u8s(1)  # version tree arity (log2)
        method = c.varint()
        if method == 1:
            c.take(4)  # zstd level
        elif method != 0:
            raise OrbaxFormatError(f"{path}: unknown node compression method {method}")
        files = _data_file_table(c)
        n = c.varint()
        gen, height = c.varints(n), c.u8s(n)
        fid, off, length = c.varints(n), c.varints(n), c.varints(n)
        nkeys = c.varints(n)
        c.varints(2 * n)  # tree bytes, indirect value bytes
        c.take(8 * n)  # commit times
        # version tree nodes: older versions only, kept for the byte count
        m = c.varint()
        c.varints(5 * m)  # generation, data file, offset, length, count
        c.take(8 * m)  # commit times
        c.u8s(m)  # heights
        c.done()
        if not n:
            raise OrbaxFormatError(f"{path}: no versions")
        v = max(range(n), key=lambda i: gen[i])
        self.values: Dict[bytes, Any] = {}
        if off[v] == _NO_ROOT:
            if nkeys[v]:
                raise OrbaxFormatError(f"{path}: empty root with {nkeys[v]} keys")
            return
        self._walk(self._file(files, fid[v], path), off[v], length[v], height[v], b"")
        if len(self.values) != nkeys[v]:
            raise OrbaxFormatError(f"{path}: {len(self.values)} keys read, the manifest "
                                   f"counts {nkeys[v]}")

    def _file(self, files: List[str], i: int, what: str) -> str:
        if i >= len(files):
            raise OrbaxFormatError(f"{what}: data file {i} not in its table")
        return files[i]

    def _read(self, rel: str, offset: int, length: int) -> bytes:
        f = self._files.get(rel)
        if f is None:
            f = self._files[rel] = open(os.path.join(self.root, rel), "rb")
        f.seek(offset)
        data = f.read(length)
        if len(data) != length:
            raise OrbaxFormatError(f"{rel}: [{offset}, {offset + length}) past its end")
        return data

    def _walk(self, rel: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        what = f"{rel}@{offset}"
        c = _Cursor(_file_body(self._read(rel, offset, length), NODE_MAGIC, what), what)
        h = c.u8s(1)[0]
        if h != height:
            raise OrbaxFormatError(f"{what}: node height {h}, its parent says {height}")
        files = _data_file_table(c)
        n = c.varint()
        if not n:
            raise OrbaxFormatError(f"{what}: empty node")
        if height == 0:
            keys, _ = _prefixed_strings(c, n)
            vlen = c.varints(n)
            kind = c.varints(n)
            if any(k > 1 for k in kind):
                raise OrbaxFormatError(f"{what}: unknown value kind {max(kind)}")
            ind = [i for i in range(n) if kind[i] == 1]
            ind_file, ind_off = c.varints(len(ind)), c.varints(len(ind))
            where = dict(zip(ind, zip(ind_file, ind_off)))
            for i, k in enumerate(keys):
                if kind[i] == 0:
                    self.values[prefix + k] = c.take(vlen[i])
                else:
                    fi, fo = where[i]
                    self.values[prefix + k] = self._read(self._file(files, fi, what), fo, vlen[i])
            c.done()
            return
        keys, subtree = _prefixed_strings(c, n, lengths=True)  # subtree prefixes
        fid, off, length = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
        c.done()
        for i, k in enumerate(keys):
            self._walk(self._file(files, fid[i], what), off[i], length[i], height - 1,
                       prefix + k[:subtree[i]])

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


# ------------------------------------------------------------------ zarr v2
def _fill(meta: Dict, dtype) -> Any:
    v = meta.get("fill_value")
    if v is None:
        return 0  # tensorstore reads a missing chunk of a null fill value as zeros
    if isinstance(v, str):
        table = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if v not in table:
            raise OrbaxFormatError(f"fill_value {v!r} is not supported")
        return table[v]
    return v


def read_zarr_array(values: Dict[bytes, Any], name: str):
    """The zarr v2 array ``name`` of a store's ``values`` (key -> bytes)."""
    raw = values.get(f"{name}/.zarray".encode())
    if raw is None:
        if f"{name}/zarr.json".encode() in values:
            raise OrbaxFormatError(f"{name}: a zarr v3 array is not supported")
        raise OrbaxFormatError(f"{name}: no {name}/.zarray in the checkpoint")
    meta = json.loads(bytes(raw))
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}: zarr format {meta.get('zarr_format')} is not supported")
    dt = meta.get("dtype")
    if dt not in _DTYPES:
        raise OrbaxFormatError(f"{name}: dtype {dt!r} is not supported")
    dtype = np.dtype(_DTYPES[dt])
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: compressor {comp.get('id')!r} is not supported")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{name}: zarr filters are not supported")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{name}: order {meta.get('order')!r} is not supported")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise OrbaxFormatError(f"{name}: dimension separator {sep!r} is not supported")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise OrbaxFormatError(f"{name}: chunks {chunks} do not fit shape {shape}")
    out = np.empty(shape, dtype)
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    grid = tuple(-(-s // c) for s, c in zip(shape, chunks))
    for idx in np.ndindex(*grid):
        key = sep.join(str(i) for i in idx) if idx else "0"
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        data = values.get(f"{name}/{key}".encode())
        if data is None:
            out[region] = _fill(meta, dtype)
            continue
        buf = zstd_decompress(data, chunk_bytes) if comp is not None else _u8(data)
        if buf.size != chunk_bytes:
            raise OrbaxFormatError(f"{name}/{key}: {buf.size} bytes, a chunk is {chunk_bytes}")
        chunk = buf.view(dtype).reshape(chunks)
        if dtype == np.bool_ and buf.max(initial=0) > 1:
            raise OrbaxFormatError(f"{name}/{key}: bool chunk holds bytes other than 0 and 1")
        if chunks == shape and comp is not None:
            out = chunk  # one chunk: the decoded buffer is the array
        else:
            out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if dt == "bfloat16":
        import torch

        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# ------------------------------------------------------------------ the tree
def is_orbax_checkpoint(path: str) -> bool:
    return os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA"))


def _assemble(leaves: List[Tuple[List[Dict], Any]], what: str) -> Any:
    """Nest ``(key_metadata, value)`` pairs: dicts for ``key_type`` 2,
    lists for ``key_type`` 1 (indices 0..n-1, every one present)."""
    if len(leaves) == 1 and not leaves[0][0]:
        return leaves[0][1]
    groups: Dict[str, List] = {}
    kinds = set()
    for keys, value in leaves:
        if not keys:
            raise OrbaxFormatError(f"{what}: a leaf at a node that has children")
        k = keys[0]
        if k.get("key_type") not in (1, 2):
            raise OrbaxFormatError(f"{what}: key type {k.get('key_type')!r} is not supported")
        kinds.add(k["key_type"])
        groups.setdefault(str(k["key"]), []).append((keys[1:], value))
    if len(kinds) != 1:
        raise OrbaxFormatError(f"{what}: a node with both dict keys and sequence indices")
    if kinds == {2}:
        return {k: _assemble(v, f"{what}.{k}") for k, v in groups.items()}
    idx = sorted(groups, key=lambda k: int(k))
    if [int(k) for k in idx] != list(range(len(idx))):
        raise OrbaxFormatError(f"{what}: sequence indices {idx} are not 0..{len(idx) - 1}")
    return [_assemble(groups[k], f"{what}.{k}") for k in idx]


def read_orbax(path: str) -> Any:
    """The tree of the Orbax checkpoint directory ``path`` (which holds
    ``_CHECKPOINT_METADATA``): what ``StandardCheckpointer().restore(path)``
    gives, with numpy arrays (``torch.bfloat16`` tensors for bfloat16)."""
    if not is_orbax_checkpoint(path):
        raise OrbaxFormatError(f"{path}: no _CHECKPOINT_METADATA (not an Orbax checkpoint)")
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.exists(meta_path):
        raise OrbaxFormatError(f"{path}: no _METADATA (an Orbax layout this reader does not "
                               f"know)")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{path}: zarr v3 arrays are not supported")
    if not meta.get("use_ocdbt"):
        raise OrbaxFormatError(f"{path}: a checkpoint without OCDBT is not supported")
    entries = list(meta["tree_metadata"].values())
    for entry in entries:
        vt = entry["value_metadata"]["value_type"]
        if vt != "np.ndarray" and vt not in _EMPTY:
            raise OrbaxFormatError(f"{path}: value type {vt!r} is not supported")
    store = OcdbtStore(path)
    try:
        # the decoder releases the GIL: arrays decode on several host threads
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            values = [pool.submit(read_zarr_array, store.values,
                                  ".".join(str(k["key"]) for k in e["key_metadata"]))
                      if e["value_metadata"]["value_type"] == "np.ndarray" else None
                      for e in entries]
            leaves = [(e["key_metadata"], v.result() if v is not None
                       else _EMPTY[e["value_metadata"]["value_type"]]())
                      for e, v in zip(entries, values)]
    finally:
        store.close()
    if not leaves:
        return {}
    # sequences come back as lists, as orbax restores them without a target
    return _assemble(leaves, path)
