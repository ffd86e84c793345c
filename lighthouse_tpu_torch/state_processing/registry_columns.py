"""Resident columnar registry: the state-attached column store that makes
epoch transitions zero-rebuild.

Counterpart of lighthouse_tpu/state_processing/registry_columns.py, copied.

The reference's tree-states layout keeps the validator registry in a
column-friendly tree and its `single_pass.rs` epoch sweep reads it without
materializing per-validator structs. This module is that capability for
this framework: a `RegistryColumns` object that

  * lives on the BeaconState (``state.__dict__["_registry_columns"]``,
    carried across ``state.copy()`` by Container.copy with per-column
    copy-on-write — copies share every array until one side writes);
  * mirrors the registry-scale persistent fields as native numpy arrays:
    five uint64 validator columns (effective_balance,
    activation_eligibility_epoch, activation_epoch, exit_epoch,
    withdrawable_epoch), the slashed bools, the 32-byte
    withdrawal_credentials rows, the per-validator pubkey subtree roots,
    plus balances and inactivity_scores as uint64 arrays;
  * stays exact through the persistent lists' dirty-token protocol
    (ssz/persistent.py): it drains its own ``COLUMNS_CHANNEL``, so a
    ``refresh()`` applies precisely the rows mutated since the last
    refresh — a steady-state epoch re-reads a handful of rows and
    rebuilds ZERO columns (chip_smoke.py's phase 6 reads the counter);
  * writes epoch-sweep results back through vectorized diffs
    (``write_balances`` / ``write_inactivity_scores`` →
    ``PersistentList.store_array``), marking the hash channel with the
    exact changed indices so the tree-hash caches' sparse ``update_rows``
    path gets its dirty set for free — and skipping its own channel,
    because the columns already hold the stored values;
  * serves the hash caches' element roots (``validator_root_rows``):
    the [m, 8, 32] Validator leaf matrix is assembled straight from the
    resident arrays (no Python object access) and folded through the
    batched hasher — both the sparse re-root and the mass-churn rebuild
    of a 1M registry never touch validator objects.

The persistent lists remain authoritative for contents (serialization,
equality, the oracle hashing path); the columns are a PROVEN mirror —
any lineage break (wholesale field replacement, token mismatch, a
non-persistent field) falls back to a counted full rebuild.
"""

from __future__ import annotations

import numpy as np

from ..analysis import sanitizer as _san
from ..metrics import REGISTRY
from ..ssz.persistent import (
    PersistentByteList,
    PersistentContainerList,
    PersistentList,
)

# The dirty channel this mirror consumes (the hash caches drain the
# default channel; see ssz/persistent.py::_DirtyTracking).
COLUMNS_CHANNEL = "columns"

# Above this fraction of rows dirty, reloading a whole uint64 column via
# one vectorized pass beats per-index Python gets.
_RELOAD_FRACTION = 8

_VALIDATOR_U64_FIELDS = (
    "effective_balance",
    "activation_eligibility_epoch",
    "activation_epoch",
    "exit_epoch",
    "withdrawable_epoch",
)

# --- eager metric registration (the series exist at zero from import) ------

_REBUILDS = REGISTRY.counter(
    "registry_columns_rebuilds_total",
    "full column rebuilds (token-lineage breaks / first builds)",
)
_WRITEBACKS = REGISTRY.counter(
    "registry_columns_row_writebacks_total",
    "rows written back from resident columns into the persistent lists",
)
for _field in (
    "validators",
    "balances",
    "inactivity_scores",
    "previous_epoch_participation",
    "current_epoch_participation",
):
    _REBUILDS.inc(0, field=_field)
    _WRITEBACKS.inc(0, field=_field)

# Per-stage spans of the epoch transition (chip_smoke.py's phase 6 reads
# the histograms for its breakdown; registered at import so they exist at
# zero).
EPOCH_STAGES = (
    "columns_refresh",
    "justification",
    "inactivity",
    "rewards",
    "registry_updates",
    "slashings",
    "effective_balances",
    "final_updates",
)
for _stage in EPOCH_STAGES:
    REGISTRY.histogram(
        # lint: allow(metric-hygiene) -- bounded by the EPOCH_STAGES tuple
        f"trace_span_seconds_epoch_stage_{_stage}",
        f"span duration: epoch_stage_{_stage}",
    )


def _u64_bytes(arr: np.ndarray) -> np.ndarray:
    """[m] uint64 → [m, 8] little-endian bytes (SSZ basic-value packing)."""
    return np.ascontiguousarray(arr, dtype="<u8").view(np.uint8).reshape(-1, 8)


def _hash_pubkeys(pubkeys: bytes, m: int) -> np.ndarray:
    """[m] 48-byte pubkeys (concatenated) → [m, 32] subtree roots: a 48-byte
    ByteVector is 2 chunks, so its root is one two-to-one hash of the
    zero-padded 64-byte row (container_leaf_matrix does the same fold)."""
    from ..utils.sha256_batch import hash_rows

    rows = np.zeros((m, 64), dtype=np.uint8)
    rows[:, :48] = np.frombuffer(pubkeys, dtype=np.uint8).reshape(m, 48)
    return hash_rows(rows)


# Column name -> the state field whose dirty channel proves it fresh
# (the validator-struct columns all derive from the validators list).
_SOURCE_FIELD = {
    "balances": "balances",
    "inactivity_scores": "inactivity_scores",
    "previous_epoch_participation": "previous_epoch_participation",
    "current_epoch_participation": "current_epoch_participation",
}


class RegistryColumns:
    """The resident column store (see module docstring).

    Every public column property returns a READ-ONLY zero-copy view
    (``setflags(write=False)``) in all modes: the arrays are CoW-shared
    across state copies, so an in-place write through a view would
    silently corrupt every aliased consumer — the only sanctioned writers
    are `write_balances` / `write_inactivity_scores` /
    `write_participation` (→ `_write_col`), which also commit the change
    into the persistent lists. Under LIGHTHOUSE_TPU_SANITIZE=1 each
    property read additionally audits the source list's dirty channel
    (rule ``stale-read``): undrained dirt means the reader skipped
    `refresh()` and is consuming a stale mirror."""

    __slots__ = (
        "_cols",
        "_shared",
        "_committed",
        "_sources",
        "_pubkey_index",
        "_stamps",
    )

    def __init__(self):
        self._cols: dict[str, np.ndarray] = {}
        self._shared: set[str] = set()
        # source field -> the dirt token this mirror committed
        self._committed: dict[str, object] = {}
        # source field -> the list it mirrors (sanitize-mode audit only)
        self._sources: dict[str, object] = {}
        # pubkey bytes -> FIRST index (API serving tier); rebuilt lazily,
        # dropped whenever pubkey rows change or the registry grows
        self._pubkey_index: dict[bytes, int] | None = None
        # per-column mutation stamps: bumped on every install AND on
        # every writable handout (an in-place row write keeps the array
        # identity, so identity alone can't invalidate derived caches —
        # the API tier's hex piece caches key on (identity, stamp))
        self._stamps: dict[str, int] = {}

    # -- copy-on-write across state copies ------------------------------

    def copy(self) -> "RegistryColumns":
        out = RegistryColumns.__new__(RegistryColumns)
        out._cols = dict(self._cols)
        out._committed = dict(self._committed)
        out._sources = dict(self._sources)
        # safe to share: invalidation replaces the dict, never mutates it
        out._pubkey_index = self._pubkey_index
        out._stamps = dict(self._stamps)
        shared = set(self._cols)
        out._shared = set(shared)
        self._shared |= shared
        return out

    def _writable(self, name: str) -> np.ndarray:
        arr = self._cols[name]
        if name in self._shared:
            arr = arr.copy()
            self._cols[name] = arr
            self._shared.discard(name)
        elif not arr.flags.writeable:
            # sanitize mode: a load_array product arrived frozen; the
            # sanctioned writers own their base, so take a writable copy
            arr = np.array(arr, copy=True)
            self._cols[name] = arr
        self._bump(name)
        return arr

    def _install(self, name: str, arr: np.ndarray):
        self._cols[name] = arr
        self._shared.discard(name)
        self._bump(name)

    def _bump(self, name: str):
        self._stamps[name] = self._stamps.get(name, 0) + 1

    def column_stamp(self, name: str) -> int:
        """Mutation stamp of a column — changes whenever the column was
        replaced OR handed out writable. Derived caches (the API tier's
        hex piece lists) pair this with the array identity."""
        return self._stamps.get(name, 0)

    # -- column access ----------------------------------------------------

    def _ro(self, name: str) -> np.ndarray | None:
        """Read-only view of a column (None when absent), stale-audited
        under the sanitizer."""
        arr = self._cols.get(name)
        if arr is None:
            return None
        if _san.enabled():
            _san.audit_column_read(
                name, self._sources.get(_SOURCE_FIELD.get(name, "validators"))
            )
        return _san.freeze_view(arr)

    @property
    def effective_balance(self) -> np.ndarray:
        return self._ro("effective_balance")

    @property
    def activation_eligibility_epoch(self) -> np.ndarray:
        return self._ro("activation_eligibility_epoch")

    @property
    def activation_epoch(self) -> np.ndarray:
        return self._ro("activation_epoch")

    @property
    def exit_epoch(self) -> np.ndarray:
        return self._ro("exit_epoch")

    @property
    def withdrawable_epoch(self) -> np.ndarray:
        return self._ro("withdrawable_epoch")

    @property
    def slashed(self) -> np.ndarray:
        return self._ro("slashed")

    @property
    def withdrawal_credentials(self) -> np.ndarray:
        return self._ro("withdrawal_credentials")

    @property
    def pubkey_root(self) -> np.ndarray:
        return self._ro("pubkey_root")

    @property
    def pubkeys(self) -> np.ndarray:
        """[n, 48] raw pubkey byte matrix (read-only view) — the API
        serving tier's one-hex-pass source."""
        return self._ro("pubkey")

    def pubkey_index(self) -> dict[bytes, int]:
        """pubkey bytes → FIRST index holding it (the spec's
        by-pubkey lookup semantics when a registry carries duplicates).
        Built lazily in one pass over the resident matrix, reused until a
        pubkey row changes or the registry grows — the seed's O(n)
        per-request scan becomes one dict hit."""
        m = self._pubkey_index
        if m is None:
            raw = self._cols["pubkey"]
            rows = raw.tobytes()
            # reversed so the earliest occurrence of a duplicate wins
            m = {
                rows[i * 48 : (i + 1) * 48]: i
                for i in range(raw.shape[0] - 1, -1, -1)
            }
            self._pubkey_index = m
        return m

    @property
    def balances(self) -> np.ndarray:
        return self._ro("balances")

    @property
    def inactivity_scores(self) -> np.ndarray | None:
        return self._ro("inactivity_scores")

    @property
    def previous_epoch_participation(self) -> np.ndarray | None:
        return self._ro("previous_epoch_participation")

    @property
    def current_epoch_participation(self) -> np.ndarray | None:
        return self._ro("current_epoch_participation")

    @property
    def validator_count(self) -> int:
        arr = self._cols.get("effective_balance")
        return 0 if arr is None else int(arr.size)

    # -- refresh (list → columns) ----------------------------------------

    def try_refresh(self, state) -> bool:
        """refresh(), but validating the state's fields first: returns
        False (touching nothing) when any mirrored field left the
        persistent representation — the caller detaches the columns and
        falls back to the object path."""
        fields = getattr(type(state), "_REGISTRY_COLUMN_FIELDS", None)
        if fields is None:
            return False
        for fname, kind in fields:
            if not isinstance(getattr(state, fname, None), kind):
                return False
        self.refresh(state)
        return True

    def refresh(self, state):
        """Bring every column exactly up to date with the state's lists.

        Each source list's COLUMNS_CHANNEL is drained once; a token match
        proves the drained indices are the complete delta since the last
        refresh, so only those rows are re-read. Any lineage break (or a
        first encounter) rebuilds that column group in one vectorized
        pass and counts in registry_columns_rebuilds_total."""
        self._refresh_validators(state.validators)
        self._refresh_uint64("balances", state.balances)
        scores = getattr(state, "inactivity_scores", None)
        if isinstance(scores, PersistentList):
            self._refresh_uint64("inactivity_scores", scores)
        for fname in (
            "previous_epoch_participation",
            "current_epoch_participation",
        ):
            part = getattr(state, fname, None)
            if isinstance(part, PersistentByteList):
                # same delta protocol as the uint64 columns — load_array/
                # per-index reads are dtype-agnostic (uint8 here)
                self._refresh_uint64(fname, part)

    _EMPTY_IDX = np.zeros(0, dtype=np.int64)

    def _sparse_indices(self, field: str, lst, n: int, old_n: int | None):
        """Drain the field's channel; return the exact dirty row indices
        (a sorted int64 array, appends included) or None when a full
        rebuild is required (lineage break, first build, or shrink).
        Always advances the channel baseline."""
        base, dirty = lst.drain_dirty(COLUMNS_CHANNEL)
        if (
            dirty is None
            or old_n is None
            or self._committed.get(field) is not base
            or n < old_n
        ):
            return None
        if not dirty and n == old_n:
            # steady-state refresh (block import re-syncs several times
            # per block): nothing changed, skip the unique/fromiter setup
            return self._EMPTY_IDX
        idx = np.unique(
            np.fromiter((i for i in dirty if i < n), dtype=np.int64)
        )
        if n > old_n:
            idx = np.union1d(idx, np.arange(old_n, n, dtype=np.int64))
        return idx

    def _grow(self, name: str, n: int) -> np.ndarray:
        """A writable version of column `name`, zero-extended to n rows."""
        cur = self._cols[name]
        if cur.shape[0] == n:
            return self._writable(name)
        out = np.zeros((n,) + cur.shape[1:], dtype=cur.dtype)
        out[: cur.shape[0]] = cur
        self._install(name, out)
        return out

    def _refresh_uint64(self, field: str, lst: PersistentList):
        n = len(lst)
        cur = self._cols.get(field)
        idx = self._sparse_indices(
            field, lst, n, None if cur is None else cur.shape[0]
        )
        if idx is None:
            self._install(field, lst.load_array())
            _REBUILDS.inc(field=field)
        elif idx.size:
            if idx.size > max(1, n // _RELOAD_FRACTION):
                # dense delta: one vectorized whole-column reload beats
                # per-index Python gets (still not a "rebuild": the
                # delta was proven, we just chose the cheaper read)
                self._install(field, lst.load_array())
            else:
                col = self._grow(field, n)
                col[idx] = [lst[int(i)] for i in idx]
        self._committed[field] = lst.dirt_token_for(COLUMNS_CHANNEL)
        if _san.enabled():
            self._sources[field] = lst

    def _refresh_validators(self, lst: PersistentContainerList):
        n = len(lst)
        cur = self._cols.get("effective_balance")
        idx = self._sparse_indices(
            "validators", lst, n, None if cur is None else cur.shape[0]
        )
        if idx is None:
            self._rebuild_validators(lst)
        elif idx.size:
            old_n = int(cur.shape[0])
            for name in _VALIDATOR_U64_FIELDS + (
                "slashed",
                "withdrawal_credentials",
                "pubkey",
                "pubkey_root",
            ):
                self._grow(name, n)
            # gather once, then one C-speed pass per column (a per-row
            # Python loop here was slower than the object-path extraction
            # it replaces at epoch-boundary churn scale)
            m = int(idx.size)
            elems = [lst[i] for i in idx.tolist()]
            for name in _VALIDATOR_U64_FIELDS:
                self._cols[name][idx] = np.fromiter(
                    (v.__dict__[name] for v in elems),
                    dtype=np.uint64,
                    count=m,
                )
            self._cols["slashed"][idx] = np.fromiter(
                (v.slashed for v in elems), dtype=bool, count=m
            )
            self._cols["withdrawal_credentials"][idx] = np.frombuffer(
                b"".join(v.withdrawal_credentials for v in elems),
                dtype=np.uint8,
            ).reshape(m, 32)
            # pubkeys are immutable for every spec operation, so prove it
            # instead of re-hashing: diff the raw bytes against the
            # resident copy and re-hash only genuinely changed rows
            # (normally zero — direct __setitem__ replacement is the one
            # path that can swap a pubkey). Appended rows are ALWAYS
            # hashed: _grow zero-extends both columns, and an all-zero
            # pubkey would otherwise diff clean while its true subtree
            # root is sha256(64 zero bytes), not zeros.
            pk = np.frombuffer(
                b"".join(v.pubkey for v in elems), dtype=np.uint8
            ).reshape(m, 48)
            raw = self._cols["pubkey"]
            changed = np.nonzero(
                (raw[idx] != pk).any(axis=1) | (idx >= old_n)
            )[0]
            if changed.size:
                raw[idx[changed]] = pk[changed]
                self._cols["pubkey_root"][idx[changed]] = _hash_pubkeys(
                    pk[changed].tobytes(), int(changed.size)
                )
                # registry growth always lands here too (appended rows
                # are forced into `changed`), so the map can never serve
                # a shrunken view of a grown registry
                self._pubkey_index = None
        # sync the "validators" marker column used for size bookkeeping
        self._committed["validators"] = lst.dirt_token_for(COLUMNS_CHANNEL)
        if _san.enabled():
            self._sources["validators"] = lst

    def _rebuild_validators(self, lst: PersistentContainerList):
        n = len(lst)
        vs = list(lst)
        for name in _VALIDATOR_U64_FIELDS:
            self._install(
                name,
                np.fromiter(
                    (v.__dict__[name] for v in vs), dtype=np.uint64, count=n
                ),
            )
        self._install(
            "slashed",
            np.fromiter((v.slashed for v in vs), dtype=bool, count=n),
        )
        wc = (
            np.frombuffer(
                b"".join(v.withdrawal_credentials for v in vs), dtype=np.uint8
            ).reshape(n, 32).copy()
            if n
            else np.zeros((0, 32), dtype=np.uint8)
        )
        self._install("withdrawal_credentials", wc)
        if n:
            raw = np.frombuffer(
                b"".join(v.pubkey for v in vs), dtype=np.uint8
            ).reshape(n, 48).copy()
            roots = _hash_pubkeys(raw.tobytes(), n)
        else:
            raw = np.zeros((0, 48), dtype=np.uint8)
            roots = np.zeros((0, 32), dtype=np.uint8)
        self._install("pubkey", raw)
        self._install("pubkey_root", roots)
        self._pubkey_index = None
        _REBUILDS.inc(field="validators")

    # -- writeback (columns → list) --------------------------------------

    def _write_col(
        self, field: str, lst, new, dtype, changed: np.ndarray | None = None
    ) -> int:
        # re-sync first: pending object-path writes (deposits, per-index
        # balance ops) since the last refresh must land in the column
        # before it can serve as the diff baseline
        self._refresh_uint64(field, lst)
        new = np.ascontiguousarray(new, dtype=dtype)
        cur = self._cols[field]
        if new.size != cur.size:
            raise ValueError(
                f"{field} writeback length {new.size} != {cur.size}"
            )
        if changed is None:
            changed = np.nonzero(cur != new)[0]
        if changed.size == 0:
            return 0
        lst.store_array(new, changed, exclude_channel=COLUMNS_CHANNEL)
        col = self._writable(field)
        col[changed] = new[changed]
        _WRITEBACKS.inc(int(changed.size), field=field)
        return int(changed.size)

    def _write_uint64(self, field: str, lst: PersistentList, new) -> int:
        return self._write_col(field, lst, new, np.uint64)

    def write_balances(self, state, new) -> int:
        """Commit an epoch sweep's balance array: vectorized diff, bulk
        store into the persistent list (exact dirty indices to the hash
        channel), column updated in place. Returns rows changed."""
        return self._write_uint64("balances", state.balances, new)

    def write_inactivity_scores(self, state, new) -> int:
        return self._write_uint64(
            "inactivity_scores", state.inactivity_scores, new
        )

    def write_participation(
        self, state, field: str, new, changed: np.ndarray | None = None
    ) -> int:
        """Commit a batched attestation pass's participation array for
        `field` ('previous_epoch_participation' /
        'current_epoch_participation'). `changed` (sorted row indices)
        skips the whole-column diff when the writer already knows its
        exact scatter set — the attestation pipeline does."""
        return self._write_col(
            field, getattr(state, field), new, np.uint8, changed
        )

    def rotate_participation(self, state):
        """Epoch-boundary rotation (process_participation_flag_updates):
        the state's previous field now holds a CoW copy of the old
        current list (same dirt tokens), and current is a fresh all-zero
        list. Move the column + its committed token along and install a
        zeros column for current — committing the fresh list's token
        directly, so the steady-state epoch still rebuilds ZERO columns."""
        cur_col = self._cols.pop("current_epoch_participation", None)
        cur_tok = self._committed.pop("current_epoch_participation", None)
        cur_src = self._sources.pop("current_epoch_participation", None)
        if cur_col is not None:
            self._cols["previous_epoch_participation"] = cur_col
            self._bump("previous_epoch_participation")
            if "current_epoch_participation" in self._shared:
                self._shared.add("previous_epoch_participation")
            else:
                self._shared.discard("previous_epoch_participation")
            self._committed["previous_epoch_participation"] = cur_tok
            if cur_src is not None:
                self._sources["previous_epoch_participation"] = cur_src
        fresh = getattr(state, "current_epoch_participation", None)
        if isinstance(fresh, PersistentByteList):
            self._install(
                "current_epoch_participation",
                np.zeros(len(fresh), dtype=np.uint8),
            )
            self._committed["current_epoch_participation"] = (
                fresh.dirt_token_for(COLUMNS_CHANNEL)
            )
            if _san.enabled():
                self._sources["current_epoch_participation"] = fresh
        else:
            self._cols.pop("current_epoch_participation", None)
            self._committed.pop("current_epoch_participation", None)
            self._sources.pop("current_epoch_participation", None)

    # -- element roots for the hash caches -------------------------------

    def validator_root_rows(self, idx: np.ndarray | None) -> np.ndarray:
        """[m, 32] Validator container roots assembled straight from the
        resident columns (idx None → all rows). Field order matches
        types/containers.py::Validator: pubkey, withdrawal_credentials,
        effective_balance, slashed, activation_eligibility_epoch,
        activation_epoch, exit_epoch, withdrawable_epoch — 8 fields, so
        the container subtree is exactly one [8, 32] leaf row folded in
        3 batched hashes. Caller must have refresh()ed first."""
        from ..ssz.cached_tree_hash import fold_chunk_matrix

        if idx is None:
            sel = slice(None)
            m = self.validator_count
        else:
            sel = idx
            m = int(idx.size)
        if m == 0:
            return np.zeros((0, 32), dtype=np.uint8)
        chunks = np.zeros((m, 8, 32), dtype=np.uint8)
        chunks[:, 0, :] = self._cols["pubkey_root"][sel]
        chunks[:, 1, :] = self._cols["withdrawal_credentials"][sel]
        chunks[:, 2, :8] = _u64_bytes(self._cols["effective_balance"][sel])
        chunks[:, 3, 0] = self._cols["slashed"][sel]
        chunks[:, 4, :8] = _u64_bytes(
            self._cols["activation_eligibility_epoch"][sel]
        )
        chunks[:, 5, :8] = _u64_bytes(self._cols["activation_epoch"][sel])
        chunks[:, 6, :8] = _u64_bytes(self._cols["exit_epoch"][sel])
        chunks[:, 7, :8] = _u64_bytes(self._cols["withdrawable_epoch"][sel])
        return fold_chunk_matrix(chunks)

    def active_mask(self, epoch: int) -> np.ndarray:
        e = np.uint64(epoch)
        return (self._cols["activation_epoch"] <= e) & (
            e < self._cols["exit_epoch"]
        )


def registry_columns_for(state) -> RegistryColumns | None:
    """The state's resident columns, attached on first use — or None when
    the state's registry fields are not in the persistent (tree-states)
    representation, in which case callers take the legacy per-snapshot
    path. Detaches a stale columns object if a field was replaced with a
    plain list (the token protocol would catch it too, but detaching
    keeps the fallback decision in one place).

    LIGHTHOUSE_TPU_RESIDENT_COLUMNS=0 disables residency process-wide —
    the legacy per-validator snapshot path is the retained oracle the
    bench's vs_baseline control and the differential suite run against."""
    import os

    if os.environ.get("LIGHTHOUSE_TPU_RESIDENT_COLUMNS") == "0":
        return None
    fields = getattr(type(state), "_REGISTRY_COLUMN_FIELDS", None)
    if fields is None:
        return None
    for fname, kind in fields:
        if not isinstance(getattr(state, fname, None), kind):
            state.__dict__.pop("_registry_columns", None)
            return None
    cols = state.__dict__.get("_registry_columns")
    if cols is None:
        cols = RegistryColumns()
        state.__dict__["_registry_columns"] = cols
    return cols
