"""Native (C++) embedded KV backend.

The reference's beacon store links LevelDB (C++,
beacon_node/store/src/leveldb_store.rs) and the slasher links LMDB/MDBX
(slasher/src/database/) — SURVEY §2.7 items 4/5. This module binds the
port's own native engine (`_native/lsm_store.cc`): a log-structured
store with CRC-checked WAL batches (atomic multi-op commits), an ordered
memtable, immutable sorted tables, and merge compaction.

The shared library is built on first use with g++ into
``lighthouse_tpu_torch/build/``, keyed by a hash of the source, and
rebuilt only when the source changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path

from .kv import DBColumn, ItemStore

_SRC = Path(__file__).resolve().parent / "_native" / "lsm_store.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

_build_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the build of this source lives: the package's build
    directory, keyed by a hash of the source."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"liblsm_store-{digest}.so"


def build_library(force: bool = False) -> str:
    """Compile lsm_store.cc into the package's build directory (once per
    source hash); a failed build raises."""
    with _build_lock:
        so = library_path()
        if force or not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [
                "g++", "-std=c++17", "-O2", "-fPIC", "-shared",
                "-Wall", "-Wextra", str(_SRC), "-o", str(tmp),
            ]
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, so)
        return str(so)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = build_library()
    lib = ctypes.CDLL(path)
    lib.lsm_open.restype = ctypes.c_void_p
    lib.lsm_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p)]
    lib.lsm_close.argtypes = [ctypes.c_void_p]
    lib.lsm_abandon.argtypes = [ctypes.c_void_p]
    lib.lsm_get.restype = ctypes.c_int
    lib.lsm_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.lsm_write_batch.restype = ctypes.c_int
    lib.lsm_write_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_char_p),
    ]
    lib.lsm_flush.restype = ctypes.c_int
    lib.lsm_flush.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)]
    lib.lsm_compact.restype = ctypes.c_int
    lib.lsm_compact.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)
    ]
    lib.lsm_scan_prefix.restype = ctypes.c_int
    lib.lsm_scan_prefix.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.lsm_stat.restype = ctypes.c_uint64
    lib.lsm_stat.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.lsm_set_mem_limit.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.lsm_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


class NativeStoreError(RuntimeError):
    pass


def _take_bytes(lib, ptr, n) -> bytes:
    try:
        return ctypes.string_at(ptr, n)
    finally:
        lib.lsm_free(ptr)


class NativeStore(ItemStore):
    """ItemStore over the native LSM engine.

    Column separation uses a key prefix `<tag>\\x00` (tags are the 3-char
    DBColumn values), preserving per-column ordered iteration via native
    prefix scans.
    """

    def __init__(self, path: str, mem_limit_bytes: int | None = None):
        self._lib = _load()
        err = ctypes.c_char_p()
        self._db = self._lib.lsm_open(
            path.encode(), ctypes.byref(err)
        )
        if not self._db:
            raise NativeStoreError(
                (err.value or b"open failed").decode(errors="replace")
            )
        if mem_limit_bytes is not None:
            self._lib.lsm_set_mem_limit(self._db, mem_limit_bytes)
        self._lock = threading.Lock()

    @staticmethod
    def _k(column: DBColumn, key: bytes) -> bytes:
        return column.value.encode() + b"\x00" + key

    def _get_raw(self, full_key: bytes, limit: int) -> bytes | None:
        val = ctypes.POINTER(ctypes.c_uint8)()
        vlen = ctypes.c_uint64()
        r = self._lib.lsm_get(
            self._db, full_key, len(full_key), limit,
            ctypes.byref(val), ctypes.byref(vlen),
        )
        if r == 0:
            return _take_bytes(self._lib, val, vlen.value)
        if r == 1:
            return None
        raise NativeStoreError("native get failed")

    def get(self, column, key):
        return self._get_raw(self._k(column, key), -1)

    def get_prefix(self, column, key, n):
        # Partial pread on the native side — large state blobs stay on disk.
        return self._get_raw(self._k(column, key), n)

    def _batch(self, ops_payload: bytes):
        err = ctypes.c_char_p()
        r = self._lib.lsm_write_batch(
            self._db, ops_payload, len(ops_payload), ctypes.byref(err)
        )
        if r != 0:
            raise NativeStoreError(
                (err.value or b"batch failed").decode(errors="replace")
            )

    @staticmethod
    def _encode_ops(ops) -> bytes:
        """ops: iterable of (type, full_key, value) with type 0=put 1=del."""
        parts = [struct.pack("<I", len(ops))]
        for t, k, v in ops:
            parts.append(struct.pack("<BII", t, len(k), len(v)))
            parts.append(k)
            parts.append(v)
        return b"".join(parts)

    def put(self, column, key, value):
        with self._lock:
            self._batch(
                self._encode_ops([(0, self._k(column, key), bytes(value))])
            )

    def delete(self, column, key):
        with self._lock:
            self._batch(self._encode_ops([(1, self._k(column, key), b"")]))

    def do_atomically(self, ops):
        encoded = []
        for op in ops:
            if op[0] == "put":
                encoded.append((0, self._k(op[1], op[2]), bytes(op[3])))
            elif op[0] == "delete":
                encoded.append((1, self._k(op[1], op[2]), b""))
            else:
                raise ValueError(f"unknown op {op[0]}")
        with self._lock:
            self._batch(self._encode_ops(encoded))

    def keys(self, column):
        prefix = column.value.encode() + b"\x00"
        out = ctypes.POINTER(ctypes.c_uint8)()
        outlen = ctypes.c_uint64()
        self._lib.lsm_scan_prefix(
            self._db, prefix, len(prefix), ctypes.byref(out),
            ctypes.byref(outlen),
        )
        buf = _take_bytes(self._lib, out, outlen.value)
        keys = []
        pos = 0
        while pos < len(buf):
            (klen,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            keys.append(buf[pos + len(prefix):pos + klen])
            pos += klen
        return keys

    def flush(self):
        err = ctypes.c_char_p()
        if self._lib.lsm_flush(self._db, ctypes.byref(err)) != 0:
            raise NativeStoreError(
                (err.value or b"flush failed").decode(errors="replace")
            )

    def compact(self):
        err = ctypes.c_char_p()
        if self._lib.lsm_compact(self._db, ctypes.byref(err)) != 0:
            raise NativeStoreError(
                (err.value or b"compact failed").decode(errors="replace")
            )

    def stats(self) -> dict:
        return {
            "sstables": self._lib.lsm_stat(self._db, 0),
            "memtable_entries": self._lib.lsm_stat(self._db, 1),
            "memtable_bytes": self._lib.lsm_stat(self._db, 2),
            "wal_bytes": self._lib.lsm_stat(self._db, 3),
        }

    def close(self):
        with self._lock:
            if self._db:
                self._lib.lsm_close(self._db)
                self._db = None

    def abandon(self):
        """Crash simulation (tests): release the handles WITHOUT the
        close-time flush, leaving disk exactly as a power loss would."""
        with self._lock:
            if self._db:
                self._lib.lsm_abandon(self._db)
                self._db = None
