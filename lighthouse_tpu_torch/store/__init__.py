"""Block/state storage (beacon_node/store equivalent).

`ItemStore` is the KV trait seam (store/src/lib.rs ItemStore/KeyValueStore);
`MemoryStore` is the in-memory test backend (store/src/memory_store.rs);
`SqliteStore` is a pure-host fallback (stdlib sqlite3); `NativeStore`
(store/native.py + _native/lsm_store.cc) is the C++ LSM engine matching
the reference's LevelDB/LMDB native storage (SURVEY §2.7 items 4/5).
`HotColdDB` splits recent (hot) data from finalized history (cold) at the
split slot (store/src/hot_cold_store.rs:50-55).
"""

from .kv import DBColumn, ItemStore, MemoryStore, SqliteStore
from .hot_cold import HotColdDB


def open_item_store(path: str, backend: str = "auto") -> ItemStore:
    """Open a persistent ItemStore at `path`.

    backend: "native" (C++ LSM), "sqlite", or "auto" — native when the
    toolchain can build it, sqlite otherwise.
    """
    if backend not in ("auto", "native", "sqlite"):
        raise ValueError(f"unknown db backend {backend!r}")
    if backend == "auto":
        import os

        # Existing layouts keep their engine: a sqlite DB is a regular
        # file, a native store is a directory.
        if os.path.isfile(path):
            backend = "sqlite"
        elif os.path.isdir(path):
            backend = "native"
    if backend in ("auto", "native"):
        try:
            from .native import NativeStore

            return NativeStore(path)
        except Exception:
            if backend != "auto":
                # an existing native store (or an explicit request) must
                # not be silently re-routed to a different engine
                raise
            from ..utils.logging import get_logger

            get_logger("lighthouse_tpu_torch.store").warning(
                "native store backend unavailable, falling back to sqlite",
                exc_info=True,
            )
    return SqliteStore(path)


def cold_path_for(path: str) -> str:
    """On-disk location of the cold store paired with a hot store at
    `path` (same engine, sibling layout)."""
    return path.rstrip("/") + ".cold"


def open_hot_cold(path: str, backend: str = "auto", types=None) -> HotColdDB:
    """Open a fully persistent HotColdDB at `path`: hot store at the path
    itself, cold store at `cold_path_for(path)`. The former single-store
    open left `cold` as a process-lifetime MemoryStore, so migrated
    history silently evaporated on restart."""
    hot = open_item_store(path, backend)
    # pin the cold side to the engine the hot side resolved to — "auto"
    # on a fresh cold path must not pick a different backend
    cold_backend = backend
    if backend == "auto":
        cold_backend = "sqlite" if isinstance(hot, SqliteStore) else "native"
    return HotColdDB(
        hot, cold=open_item_store(cold_path_for(path), cold_backend), types=types
    )


__all__ = [
    "DBColumn",
    "ItemStore",
    "MemoryStore",
    "SqliteStore",
    "HotColdDB",
    "open_item_store",
    "open_hot_cold",
    "cold_path_for",
]
