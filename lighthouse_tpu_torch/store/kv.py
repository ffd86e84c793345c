"""Key-value store backends behind one trait.

Mirrors beacon_node/store/src/lib.rs: per-column keyspaces (`DBColumn`
:218), an `ItemStore` trait, `MemoryStore` for tests, and a host-native
persistent backend (sqlite3; the reference links LevelDB/C++)."""

from __future__ import annotations

import sqlite3
import threading
from enum import Enum


class DBColumn(str, Enum):
    """Column families (store/src/lib.rs DBColumn)."""

    BEACON_BLOCK = "blk"
    BEACON_STATE = "ste"
    BEACON_META = "bma"
    BEACON_BLOCK_ROOTS = "bbr"
    BEACON_STATE_ROOTS = "bsr"
    BEACON_HISTORICAL_ROOTS = "bhr"
    BEACON_RANDAO_MIXES = "brm"
    FORK_CHOICE = "frk"
    OP_POOL = "opo"
    ETH1_CACHE = "etc"
    HOT_STATE_SUMMARY = "hss"
    BLOB_SIDECARS = "blb"
    DATA_COLUMNS = "dcl"
    SLASHER_ATTESTATION = "sat"
    SLASHER_INDEXED = "sai"
    SLASHER_BLOCK = "sbk"
    # chunked min/max-span tiles (slasher/spans.py): key = epoch_chunk
    # (8B BE) || validator_chunk (8B BE), value = uint16-LE tile
    SLASHER_MIN_SPAN = "smn"
    SLASHER_MAX_SPAN = "smx"


class ItemStore:
    """The KV trait: get/put/delete/iterate per column."""

    def get(self, column: DBColumn, key: bytes) -> bytes | None:
        raise NotImplementedError

    def put(self, column: DBColumn, key: bytes, value: bytes):
        raise NotImplementedError

    def delete(self, column: DBColumn, key: bytes):
        raise NotImplementedError

    def exists(self, column: DBColumn, key: bytes) -> bool:
        return self.get(column, key) is not None

    def get_prefix(self, column: DBColumn, key: bytes, n: int) -> bytes | None:
        """First `n` bytes of a value. Default reads the whole value;
        backends with partial reads (sqlite substr) override."""
        v = self.get(column, key)
        return None if v is None else v[:n]

    def keys(self, column: DBColumn):
        raise NotImplementedError

    def stats(self, column: DBColumn) -> tuple[int, int]:
        """(key count, total value bytes) for one column — the
        `/lighthouse/health` store block's raw material. Default walks
        keys+values; backends with cheaper aggregates override."""
        count = 0
        total = 0
        for key in self.keys(column):
            v = self.get(column, key)
            if v is not None:
                count += 1
                total += len(v)
        return count, total

    def do_atomically(self, ops: list):
        """ops: list of ("put", col, key, value) | ("delete", col, key)."""
        for op in ops:
            if op[0] == "put":
                self.put(op[1], op[2], op[3])
            elif op[0] == "delete":
                self.delete(op[1], op[2])
            else:
                raise ValueError(f"unknown op {op[0]}")

    def close(self):
        pass


class MemoryStore(ItemStore):
    """In-memory store for tests (store/src/memory_store.rs)."""

    def __init__(self):
        self._data: dict[tuple[str, bytes], bytes] = {}
        self._lock = threading.Lock()

    def get(self, column, key):
        return self._data.get((column.value, key))

    def put(self, column, key, value):
        with self._lock:
            self._data[(column.value, key)] = bytes(value)

    def delete(self, column, key):
        with self._lock:
            self._data.pop((column.value, key), None)

    def keys(self, column):
        with self._lock:
            return [k for (c, k) in self._data if c == column.value]

    def stats(self, column):
        with self._lock:
            sizes = [
                len(v)
                for (c, _k), v in self._data.items()
                if c == column.value
            ]
        return len(sizes), sum(sizes)

    def do_atomically(self, ops):
        with self._lock:
            for op in ops:
                if op[0] == "put":
                    self._data[(op[1].value, op[2])] = bytes(op[3])
                elif op[0] == "delete":
                    self._data.pop((op[1].value, op[2]), None)
                else:
                    raise ValueError(f"unknown op {op[0]}")


class SqliteStore(ItemStore):
    """Persistent KV over sqlite3 (native C storage engine). One table per
    column, WAL mode, atomic batches via transactions."""

    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        for col in DBColumn:
            self._conn.execute(
                f"CREATE TABLE IF NOT EXISTS c_{col.value} "
                "(k BLOB PRIMARY KEY, v BLOB NOT NULL)"
            )
        self._conn.commit()

    def get(self, column, key):
        cur = self._conn.execute(
            f"SELECT v FROM c_{column.value} WHERE k = ?", (key,)
        )
        row = cur.fetchone()
        return row[0] if row else None

    def put(self, column, key, value):
        with self._lock:
            self._conn.execute(
                f"INSERT OR REPLACE INTO c_{column.value} (k, v) VALUES (?, ?)",
                (key, bytes(value)),
            )
            self._conn.commit()

    def delete(self, column, key):
        with self._lock:
            self._conn.execute(
                f"DELETE FROM c_{column.value} WHERE k = ?", (key,)
            )
            self._conn.commit()

    def keys(self, column):
        cur = self._conn.execute(f"SELECT k FROM c_{column.value}")
        return [row[0] for row in cur.fetchall()]

    def stats(self, column):
        cur = self._conn.execute(
            f"SELECT count(*), coalesce(sum(length(v)), 0) "
            f"FROM c_{column.value}"
        )
        count, total = cur.fetchone()
        return int(count), int(total)

    def get_prefix(self, column, key, n):
        # substr keeps multi-hundred-KiB blob values out of the page
        # cache when only the slot prefix is wanted
        cur = self._conn.execute(
            f"SELECT substr(v, 1, ?) FROM c_{column.value} WHERE k = ?",
            (n, key),
        )
        row = cur.fetchone()
        return row[0] if row else None

    def do_atomically(self, ops):
        with self._lock:
            try:
                for op in ops:
                    if op[0] == "put":
                        self._conn.execute(
                            f"INSERT OR REPLACE INTO c_{op[1].value} (k, v) "
                            "VALUES (?, ?)",
                            (op[2], bytes(op[3])),
                        )
                    elif op[0] == "delete":
                        self._conn.execute(
                            f"DELETE FROM c_{op[1].value} WHERE k = ?", (op[2],)
                        )
                    else:
                        raise ValueError(f"unknown op {op[0]}")
                self._conn.commit()
            except Exception:
                self._conn.rollback()
                raise

    def close(self):
        self._conn.close()
