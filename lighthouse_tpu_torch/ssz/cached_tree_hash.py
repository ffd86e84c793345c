"""Incremental Merkleization with dirty-index propagation.

The capability of the reference's `consensus/cached_tree_hash` crate
(cache.rs:14-161: `update_leaves` phase 1, `update_merkle_root` phase 2,
`lift_dirty`) re-designed around flat numpy layers instead of a pointer
arena: every tree level is one contiguous [n_level, 32] uint8 array and
dirty paths are re-hashed level by level (`lift_dirty` ==
`np.unique(dirty >> 1)`) through the batched row hasher
(utils/sha256_batch.hash_rows).

Three update tiers, fastest first:

  1. **Sparse (dirty-index) updates**: the persistent lists
     (ssz/persistent.py) record every mutated element index; `update_rows`
     writes just those chunks and lifts just those paths. A warm
     block-import re-root at 1M validators touches ~130 chunks — no full
     scan, no full diff, ever. The token protocol (`drain_dirty`) proves
     the index set is an exact delta against what this cache committed;
     any lineage break falls back to tier 2.
  2. **Full diff**: extract all leaves, vectorized compare against the
     committed layer, lift only real changes (the original cache.rs
     behavior). Used for plain-list fields, bytearray participation
     flags, and token mismatches.
  3. **Batched rebuild**: past `_REBUILD_FRACTION` dirty (or on pow2
     growth/shrink), rebuild every level in one batched pass per level.
     Validator registries rebuild *columnar*: an [n, 8, 32] leaf matrix
     (pubkey root, withdrawal_credentials, effective_balance, slashed,
     the four epochs) extracted one numpy pass per field, folded to
     per-validator container roots in 7 batched hashes per validator —
     never one Python `hash_tree_root_of` per element.

Layer sizing follows SSZ `merkleize`: layers cover next_pow_of_two(count)
leaves; the remaining depth up to the type's limit is folded with
ZERO_HASHES (those folds are recomputed per update — log2(limit) hashes).

`TreeHashCache.copy()` is copy-on-write: committed layers are shared
until the first dirty write (a `state.copy()` no longer duplicates
~64 MB of layers at 1M validators).

The BeaconState-level cache (`BeaconStateHashCache`) mirrors
`BeaconState::update_tree_hash_cache` (consensus/types/src/beacon_state.rs:
2002-2004 via milhouse): the big registry-shaped fields each own a cache;
everything else is recomputed per call — those fields are O(1)-sized.

Big batches hash on the default device (lighthouse_tpu_torch/device.py):
a full build of at least `_DEVICE_BUILD_THRESHOLD` leaves runs its levels
on the SHA-256 kernel (ops/sha256.merkle_tree_levels), and every batched
row hash (`_hash_rows`: path lifts, the columnar container fold) goes
through utils/sha256_batch.hash_rows, which sends batches of
`_BATCH_MIN` rows or more to the same kernel. There is no opt-in flag and
no fallback: a kernel failure raises.
"""

from __future__ import annotations

import numpy as np

from ..utils.hash import ZERO_HASHES, hash32_concat
from ..utils.sha256_batch import hash_rows
from .merkle import next_pow_of_two

# full rebuilds are faster than path updates past this dirty fraction
_REBUILD_FRACTION = 0.5
_DEVICE_BUILD_THRESHOLD = 1 << 11

# instrumentation, read through stats()
_STATS = {"rows_hashed": 0, "full_extracts": 0, "sparse_updates": 0, "rebuilds": 0}


def stats() -> dict:
    return dict(_STATS)


def _hash_rows(pairs: np.ndarray) -> np.ndarray:
    """[n, 64] uint8 → [n, 32] uint8 through the row-hash dispatcher."""
    _STATS["rows_hashed"] += pairs.shape[0]
    return hash_rows(pairs)


def _build_layers(leaves: np.ndarray) -> list[np.ndarray]:
    """Full build: layers[0] = leaves (padded to pow2), layers[-1] = [1, 32].
    Big trees run their levels on the SHA-256 kernel; small ones hash one
    batched host pass per level."""
    _STATS["rebuilds"] += 1
    n = leaves.shape[0]
    full = next_pow_of_two(n)
    if full != n:
        leaves = np.vstack(
            [leaves, np.zeros((full - n, 32), dtype=np.uint8)]
        )
    if full >= _DEVICE_BUILD_THRESHOLD:
        from ..ops.sha256 import merkle_tree_levels

        # fresh arrays copied back from the device buffer: layer 0 never
        # aliases the caller's leaves
        return merkle_tree_levels(leaves)[::-1]
    # layer 0 is the committed copy — never alias (or inherit the
    # read-only flag of) the caller's buffer
    leaves = np.array(leaves, dtype=np.uint8, copy=True)
    layers = [leaves]
    cur = leaves
    while cur.shape[0] > 1:
        cur = _hash_rows(cur.reshape(-1, 64))
        layers.append(cur)
    return layers


class TreeHashCache:
    """Incremental Merkle root over a leaf-chunk array with a static limit.

    `update(leaves)` diffs against the committed leaves and re-hashes only
    dirty paths; `update_rows(chunk_idx, rows, count)` skips the diff
    entirely when the caller already knows the dirty chunks. `copy()` is
    copy-on-write: layers are shared until the first dirty write."""

    def __init__(self, limit_chunks: int):
        self.limit = limit_chunks
        self.depth = (next_pow_of_two(limit_chunks) - 1).bit_length()
        self.layers: list[np.ndarray] | None = None
        self.count = 0
        self._shared = False

    def copy(self) -> "TreeHashCache":
        out = TreeHashCache.__new__(TreeHashCache)
        out.limit = self.limit
        out.depth = self.depth
        out.count = self.count
        if self.layers is None:
            out.layers = None
            out._shared = False
        else:
            # CoW: share the committed arrays; either side clones on its
            # first in-place write
            out.layers = list(self.layers)
            out._shared = True
            self._shared = True
        return out

    def _unshare(self):
        if self._shared:
            self.layers = [a.copy() for a in self.layers]
            self._shared = False

    def _fold_to_depth(self) -> bytes:
        root = self.layers[-1][0].tobytes()
        sub_depth = len(self.layers) - 1
        for level in range(sub_depth, self.depth):
            root = hash32_concat(root, ZERO_HASHES[level])
        return root

    def root_only(self) -> bytes:
        """The committed root without any update (no-op re-root)."""
        return self._fold_to_depth()

    def can_sparse(self, n_chunks: int) -> bool:
        """True when `update_rows` may be used for a list now holding
        `n_chunks` chunks: committed, no shrink, same pow2 envelope."""
        return (
            self.layers is not None
            and n_chunks >= self.count
            and next_pow_of_two(n_chunks) == self.layers[0].shape[0]
        )

    def _lift(self, dirty: np.ndarray):
        """Phase 2 (update_merkle_root): re-hash dirty paths level by level."""
        idx = np.unique(dirty >> 1)
        for level in range(len(self.layers) - 1):
            src = self.layers[level]
            dst = self.layers[level + 1]
            pairs = src.reshape(-1, 64)[idx]
            dst[idx] = _hash_rows(pairs)
            idx = np.unique(idx >> 1)

    def update_rows(self, chunk_idx: np.ndarray, rows: np.ndarray, count: int) -> bytes:
        """Sparse fast path: commit `rows` at `chunk_idx` (the ONLY chunks
        that changed — including any appended past the old count) and lift
        just those paths. Caller must have checked `can_sparse(count)`."""
        if not self.can_sparse(count):
            raise ValueError("sparse update outside the committed envelope")
        _STATS["sparse_updates"] += 1
        self.count = count
        if chunk_idx.size == 0:
            return self._fold_to_depth()
        self._unshare()
        self.layers[0][chunk_idx] = rows
        self._lift(chunk_idx)
        return self._fold_to_depth()

    def update(self, leaves: np.ndarray) -> bytes:
        """leaves: [n, 32] uint8 (n ≤ limit). Returns the merkle root
        (zero-padded to the limit depth, no length mix)."""
        n = leaves.shape[0]
        if n > self.limit:
            raise ValueError(f"{n} chunks exceeds limit {self.limit}")
        if (
            self.layers is None
            or next_pow_of_two(n) != self.layers[0].shape[0]
            or n < self.count
        ):
            # first build, pow2 growth, or shrink: rebuild
            self.layers = _build_layers(leaves)
            self._shared = False
            self.count = n
            return self._fold_to_depth()

        committed = self.layers[0]
        dirty = np.nonzero((committed[:n] != leaves).any(axis=1))[0]
        if n > self.count:
            dirty = np.union1d(dirty, np.arange(self.count, n))
        if dirty.size == 0:
            self.count = n
            return self._fold_to_depth()
        if dirty.size > _REBUILD_FRACTION * max(n, 1):
            self.layers = _build_layers(leaves)
            self._shared = False
            self.count = n
            return self._fold_to_depth()

        self._unshare()
        self.layers[0][:n] = leaves
        self.count = n
        self._lift(dirty)
        return self._fold_to_depth()


# ---------------------------------------------------------------------------
# Columnar container Merkleization (the batched per-validator subtree pass)
# ---------------------------------------------------------------------------


def container_leaf_matrix(cls, elems: list) -> np.ndarray | None:
    """[n, pad_f, 32] uint8 leaf chunks for n container elements, one
    vectorized pass per field. Multi-chunk ByteVector fields (pubkey:
    48 B → 2 chunks) are pre-folded to their subtree root, so row f of
    each element is that field's chunk in the container's Merkle tree.

    Requires a fixed-size container of basic uints / boolean / ByteVector
    (the Validator shape); returns None for anything else."""
    from .core import ByteVector, boolean, uint8, uint16, uint32, uint64

    fields = cls._fields
    n = len(elems)
    pad_f = next_pow_of_two(len(fields))
    chunks = np.zeros((n, pad_f, 32), dtype=np.uint8)
    for fi, (fname, ftype) in enumerate(fields.items()):
        col = [v.__dict__[fname] for v in elems]
        if isinstance(ftype, type) and issubclass(ftype, ByteVector):
            size = ftype.fixed_size()
            buf = np.frombuffer(b"".join(col), dtype=np.uint8).reshape(n, size)
            if size <= 32:
                chunks[:, fi, :size] = buf
            else:
                # multi-chunk bytes field: fold its subtree batched
                pad_c = next_pow_of_two((size + 31) // 32)
                sub = np.zeros((n, pad_c * 32), dtype=np.uint8)
                sub[:, :size] = buf
                while pad_c > 1:
                    sub = _hash_rows(sub.reshape(n * pad_c // 2, 64)).reshape(
                        n, -1
                    )
                    pad_c //= 2
                chunks[:, fi, :] = sub.reshape(n, 32)
        elif isinstance(ftype, type) and issubclass(
            ftype, (boolean, uint8, uint16, uint32, uint64)
        ):
            size = ftype.fixed_size()
            arr = np.fromiter(col, dtype=np.uint64, count=n)
            raw = arr.astype("<u8").view(np.uint8).reshape(n, 8)
            chunks[:, fi, :size] = raw[:, :size]
        else:
            return None  # unsupported shape
    return chunks


def fold_chunk_matrix(chunks: np.ndarray) -> np.ndarray:
    """Fold an [n, pad_f, 32] leaf matrix to [n, 32] container roots —
    log2(pad_f) batched hashes across the whole batch."""
    n, pad_f, _ = chunks.shape
    cur = chunks.reshape(n * pad_f // 2, 64)
    width = pad_f
    while width > 1:
        cur = _hash_rows(cur)
        width //= 2
        if width > 1:
            cur = cur.reshape(n * width // 2, 64)
    return cur.reshape(n, 32)


def container_roots_columnar(cls, elems: list) -> np.ndarray | None:
    """[n, 32] container roots in one columnar pass, or None when the
    element shape doesn't vectorize (callers fall back per-element)."""
    if not elems:
        return np.zeros((0, 32), dtype=np.uint8)
    chunks = container_leaf_matrix(cls, elems)
    if chunks is None:
        return None
    return fold_chunk_matrix(chunks)


def _element_root_rows(elem_t, elems: list) -> np.ndarray:
    """[d, 32] roots for a (usually small) gather of elements; columnar
    when the shape allows, per-element SSZ otherwise."""
    rows = container_roots_columnar(elem_t, elems) if elem_t is not None else None
    if rows is None:
        rows = np.frombuffer(
            b"".join(type(v).hash_tree_root_of(v) for v in elems),
            dtype=np.uint8,
        ).reshape(len(elems), 32)
    return rows


# ---------------------------------------------------------------------------
# Dirty-index-driven field caches (persistent-list-backed registry fields)
# ---------------------------------------------------------------------------


class _TokenListCache:
    """Shared protocol: a TreeHashCache advanced by a persistent list's
    drain_dirty() deltas, with the committed-token check that makes the
    sparse path provably exact (see ssz/persistent.py::_DirtyTracking)."""

    def __init__(self, limit_chunks: int):
        self.tree = TreeHashCache(limit_chunks)
        self._committed: object | None = None

    def copy(self):
        out = type(self).__new__(type(self))
        out.tree = self.tree.copy()
        out._committed = self._committed
        return out

    def _dirty_chunks(self, value, n_chunks: int, to_chunk) -> set | None:
        """Drain the list and return the dirty CHUNK index set for the
        sparse path (appends included), or None when a full pass is
        required — unknown delta, token-lineage break, pow2 envelope
        change, or more dirty chunks than the rebuild fraction allows.
        Always advances the list's baseline."""
        base, dirty = value.drain_dirty()
        if (
            dirty is None
            or self._committed is not base
            or not self.tree.can_sparse(n_chunks)
        ):
            return None
        chunk_idx = to_chunk(dirty)
        chunk_idx.update(range(self.tree.count, n_chunks))  # appends
        if len(chunk_idx) > _REBUILD_FRACTION * max(n_chunks, 1):
            return None
        return chunk_idx


class Uint64ListCache(_TokenListCache):
    """Cache for PersistentList-backed uint64 fields (balances,
    inactivity_scores): element dirt maps 4-to-1 onto packed chunks."""

    def root(self, value) -> bytes:
        n = len(value)
        n_chunks = (n + 3) // 4
        chunk_idx = self._dirty_chunks(
            value, n_chunks, lambda d: {e >> 2 for e in d if e < n}
        )
        if chunk_idx is None:
            _STATS["full_extracts"] += 1
            root = self.tree.update(value.to_chunk_array())
        elif not chunk_idx:
            root = self.tree.root_only()
        else:
            idx = np.fromiter(sorted(chunk_idx), dtype=np.int64)
            rows = np.zeros((idx.size, 4), dtype=np.uint64)
            for r, c in enumerate(idx):
                lo = int(c) * 4
                for k in range(min(4, n - lo)):
                    rows[r, k] = value[lo + k]
            root = self.tree.update_rows(
                idx, rows.view(np.uint8).reshape(-1, 32), n_chunks
            )
        self._committed = value.dirt_token
        return root


class ByteListCache(_TokenListCache):
    """Cache for PersistentByteList-backed fields (the altair
    participation-flag lists): element dirt maps 32-to-1 onto packed
    chunks, so a block's worth of attestation flag writes re-roots as a
    handful of chunk paths instead of a full 1M-byte diff."""

    def root(self, value) -> bytes:
        n = len(value)
        n_chunks = (n + 31) // 32
        chunk_idx = self._dirty_chunks(
            value, n_chunks, lambda d: {e >> 5 for e in d if e < n}
        )
        if chunk_idx is None:
            _STATS["full_extracts"] += 1
            root = self.tree.update(value.to_chunk_matrix())
        elif not chunk_idx:
            root = self.tree.root_only()
        else:
            idx = np.fromiter(sorted(chunk_idx), dtype=np.int64)
            root = self.tree.update_rows(
                idx, value.chunk_rows(idx), n_chunks
            )
        self._committed = value.dirt_token
        return root


class ContainerListCache(_TokenListCache):
    """Cache for a PersistentContainerList registry (validators): layer 0
    is the per-element container roots; dirty elements re-root through
    the columnar batched subtree pass.

    `row_source` (optional) is a callable(idx | None) -> [m, 32] element
    root rows — the resident-column provider
    (RegistryColumns.validator_root_rows), which assembles leaf matrices
    straight from numpy columns so neither the sparse re-root nor the
    mass-churn full path ever extracts Python validator objects."""

    def root(self, value, row_source=None) -> bytes:
        n = len(value)
        idx_set = self._dirty_chunks(
            value, n, lambda d: {i for i in d if i < n}
        )
        if idx_set is None:
            _STATS["full_extracts"] += 1
            if row_source is not None:
                rows = row_source(None)
            else:
                rows = _element_root_rows(value.elem_t, list(value))
            root = self.tree.update(rows)
        elif not idx_set:
            root = self.tree.root_only()
        else:
            idx = np.fromiter(sorted(idx_set), dtype=np.int64)
            if row_source is not None:
                rows = row_source(idx)
            else:
                rows = _element_root_rows(
                    value.elem_t, [value[int(i)] for i in idx]
                )
            root = self.tree.update_rows(idx, rows, n)
        self._committed = value.dirt_token
        return root


# ---------------------------------------------------------------------------
# Leaf extraction for the plain-list (non-persistent) fallback paths
# ---------------------------------------------------------------------------


def _pack_uint64(values, limit_chunks: int) -> np.ndarray:
    arr = np.asarray(values, dtype=np.uint64)
    n_chunks = (arr.size + 3) // 4
    buf = np.zeros(n_chunks * 4, dtype=np.uint64)
    buf[: arr.size] = arr
    return buf.view(np.uint8).reshape(-1, 32)  # little-endian hosts


def _pack_bytes(data: bytes | bytearray) -> np.ndarray:
    b = np.frombuffer(bytes(data), dtype=np.uint8)
    n_chunks = max(1, (b.size + 31) // 32) if b.size else 0
    buf = np.zeros(n_chunks * 32, dtype=np.uint8)
    buf[: b.size] = b
    return buf.reshape(-1, 32)


def _pack_roots(roots: list[bytes]) -> np.ndarray:
    if not roots:
        return np.zeros((0, 32), dtype=np.uint8)
    return np.frombuffer(b"".join(roots), dtype=np.uint8).reshape(-1, 32)


def _validator_root(v) -> bytes:
    """Per-validator container root, memoized on the object. Validator
    fields are immutable scalars/bytes, so `Container.__setattr__` is the
    only mutation path — it clears the memo."""
    root = v.__dict__.get("_thc_root")
    if root is None:
        root = type(v).hash_tree_root_of(v)
        v.__dict__["_thc_root"] = root
    return root


class BeaconStateHashCache:
    """Per-state incremental hasher for the registry-scale fields."""

    # field -> leaf extractor for the PLAIN-list fallback (persistent
    # lists ride the dirty-index caches instead)
    LIST_FIELDS = {
        "validators": (
            lambda state, E: _pack_roots([_validator_root(v) for v in state.validators])
        ),
        "balances": (lambda state, E: _pack_uint64(state.balances, 0)),
        "previous_epoch_participation": (
            lambda state, E: _pack_bytes(state.previous_epoch_participation)
        ),
        "current_epoch_participation": (
            lambda state, E: _pack_bytes(state.current_epoch_participation)
        ),
        "inactivity_scores": (
            lambda state, E: _pack_uint64(state.inactivity_scores, 0)
        ),
    }
    VECTOR_FIELDS = {
        "block_roots": lambda state, E: _pack_roots(list(state.block_roots)),
        "state_roots": lambda state, E: _pack_roots(list(state.state_roots)),
        "randao_mixes": lambda state, E: _pack_roots(list(state.randao_mixes)),
        "slashings": lambda state, E: _pack_uint64(state.slashings, 0),
    }

    def __init__(self):
        self._caches: dict[str, object] = {}

    def copy(self) -> "BeaconStateHashCache":
        out = BeaconStateHashCache()
        out._caches = {k: c.copy() for k, c in self._caches.items()}
        return out

    def rotate_participation(self):
        """Epoch-boundary participation rotation (altair
        process_participation_flag_updates): previous ← current, current
        ← zeros. The committed tokens ride the rotated list objects, so
        moving the per-field cache along keeps the NEXT block's
        attestation writes on the sparse update path; the fresh current
        field rebuilds its (all-zeros) tree on first use."""
        cur = self._caches.pop("current_epoch_participation", None)
        if cur is not None and type(cur) is ByteListCache:
            self._caches["previous_epoch_participation"] = cur
        else:
            self._caches.pop("previous_epoch_participation", None)

    def _cache_for(self, fname: str, ftype, kind=TreeHashCache):
        """The per-field cache, re-created when a field's runtime
        representation changed kind (e.g. plain list → persistent after
        `_make_persistent`)."""
        c = self._caches.get(fname)
        if c is None or type(c) is not kind:
            c = kind(ftype.chunk_count())
            self._caches[fname] = c
        return c

    def field_root(self, state, fname: str, ftype) -> bytes | None:
        """Cached root for `fname`, or None if the field isn't cacheable."""
        cacheable = getattr(type(state), "_THC_LIST_FIELDS", None)
        if cacheable is not None and fname not in cacheable:
            ext = self.VECTOR_FIELDS.get(fname)
            if ext is None:
                return None
        ent = self.LIST_FIELDS.get(fname)
        if ent is not None and hasattr(state, fname):
            from .merkle import mix_in_length

            value = getattr(state, fname)
            from .persistent import (
                PersistentByteList,
                PersistentContainerList,
                PersistentList,
            )

            if isinstance(value, PersistentContainerList):
                cache = self._cache_for(fname, ftype, ContainerListCache)
                row_source = None
                if fname == "validators":
                    # resident columns, when attached: refresh() brings
                    # them exactly up to date (token-proved), then they
                    # serve element roots without touching objects
                    cols = state.__dict__.get("_registry_columns")
                    if cols is not None:
                        if cols.try_refresh(state):
                            row_source = cols.validator_root_rows
                        else:
                            # a mirrored field left the persistent
                            # representation: detach, object path
                            state.__dict__.pop("_registry_columns", None)
                return mix_in_length(
                    cache.root(value, row_source), len(value)
                )
            if isinstance(value, PersistentList):
                cache = self._cache_for(fname, ftype, Uint64ListCache)
                return mix_in_length(cache.root(value), len(value))
            if isinstance(value, PersistentByteList):
                cache = self._cache_for(fname, ftype, ByteListCache)
                return mix_in_length(cache.root(value), len(value))
            cache = self._cache_for(fname, ftype)
            root = cache.update(ent(state, None))
            return mix_in_length(root, len(value))
        ext = self.VECTOR_FIELDS.get(fname)
        if ext is not None and hasattr(state, fname):
            cache = self._cache_for(fname, ftype)
            return cache.update(ext(state, None))
        return None


def cached_state_root(state) -> bytes:
    """Drop-in `hash_tree_root` for BeaconState containers: big fields ride
    the incremental caches (carried across `state.copy()`), the rest
    recompute — the `update_tree_hash_cache` analog."""
    cache = state.__dict__.get("_thc_cache")
    if cache is None:
        cache = BeaconStateHashCache()
        state.__dict__["_thc_cache"] = cache
    from .merkle import merkleize

    chunks = []
    for fname, ftype in state._fields.items():
        root = cache.field_root(state, fname, ftype)
        if root is None:
            root = ftype.hash_tree_root_of(getattr(state, fname))
        chunks.append(root)
    return merkleize(chunks)
