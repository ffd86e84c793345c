"""Persistent (structurally-shared) lists with internal hash caching.

The milhouse analog (the "tree-states" backbone: reference
consensus/types/src/beacon_state.rs:34,371 stores `validators`/`balances`
as milhouse `List`s with structural sharing + internal hash caches).
Re-designed for this framework's flat-array style instead of milhouse's
pointer tree:

- elements live in fixed-size blocks (4096 × uint64 = 1024 SSZ chunks =
  a depth-10 subtree), so block boundaries align with Merkle subtrees;
- `copy()` is O(#blocks): both lists drop in-place ownership and share
  the block objects (copy-on-write — a mutation clones only its block);
- every block memoizes its subtree root, so `hash_tree_root()` after k
  mutated blocks costs k block-rebuilds + one fold over #block roots —
  the structural-sharing half of what `cached_tree_hash` does for
  monolithic arrays, but carried across state copies for free.

Supports the exact mutation surface the state transition uses on
balances/inactivity_scores: indexing, slice read/assign, `append`,
iteration, `len`, equality (accessors.py:263-267, altair.py:559-562,
per_block.py:653, per_epoch.py:440)."""

from __future__ import annotations

import hashlib

from ..utils.hash import ZERO_HASHES, hash32_concat

BLOCK_ELEMS = 4096  # uint64 elements per block
_CHUNKS_PER_BLOCK = BLOCK_ELEMS * 8 // 32  # 1024
_BLOCK_DEPTH = (_CHUNKS_PER_BLOCK - 1).bit_length()  # 10

_U64_MAX = (1 << 64) - 1

# Past this many tracked dirty indices, collapse to "everything dirty":
# the consumer's full-rebuild path beats per-index bookkeeping anyway
# (cached_tree_hash._REBUILD_FRACTION territory).
_DIRTY_CAP = 1 << 16

# Dirty channel consumed by the hash caches (ssz/cached_tree_hash.py) —
# the default channel, so the original single-consumer API is unchanged.
HASH_CHANNEL = "hash"


class _DirtChannel:
    """One consumer's view of a list's pending dirt (see _DirtyTracking)."""

    __slots__ = ("dirty", "dirty_all", "token")

    def __init__(self):
        self.dirty: set[int] = set()
        self.dirty_all = False
        self.token: object = object()

    def copy(self) -> "_DirtChannel":
        out = _DirtChannel.__new__(_DirtChannel)
        out.dirty = set(self.dirty)
        out.dirty_all = self.dirty_all
        out.token = self.token
        return out

    def reset(self):
        self.dirty = set()
        self.dirty_all = False
        self.token = object()


class _DirtyTracking:
    """Dirty-index propagation shared by both persistent list flavors.

    Every mutating entry point records the touched element index, so
    consumers re-process only touched rows instead of re-scanning or
    re-diffing the whole registry. There are two independent consumers —
    the state-level hash caches (ssz/cached_tree_hash.py, the default
    `HASH_CHANNEL`) and the resident registry columns
    (state_processing/registry_columns.py) — so the dirt is tracked per
    *channel*: every mark lands in every channel, and each consumer
    drains only its own. The protocol is token-based so a consumer can
    PROVE the set is an exact delta against what it committed:

      * each channel's `token` identifies that consumer's dirty
        *baseline*: the invariant is "contents == snapshot-at-token +
        changes in the channel's dirty set". `copy()` shares tokens and
        duplicates pending sets (both sides keep the same baselines);
        any wholesale rebuild issues fresh tokens with empty sets.
      * `drain_dirty(channel)` hands the channel's pending set to its
        consumer and advances that channel's baseline only. A consumer
        whose committed token matches the drained baseline may apply
        just those indices; anything else must fall back to a full
        diff/rebuild (the milhouse analog: reuse the tree only when you
        can prove lineage).
      * Overflowing the class's `_dirty_cap` degrades a channel to
        indices=None ("everything may have changed") — mass-churn sweeps
        pay one full batched rebuild instead of set bookkeeping. The
        container list raises the cap (see PersistentContainerList):
        with columnar element roots, exact indices stay profitable far
        past the uint64 lists' threshold.
    """

    __slots__ = ()

    _dirty_cap = _DIRTY_CAP

    def _init_dirt(self):
        self._channels: dict[str, _DirtChannel] = {
            HASH_CHANNEL: _DirtChannel()
        }

    def _copy_dirt_to(self, out):
        out._channels = {k: ch.copy() for k, ch in self._channels.items()}

    def _reset_dirt(self):
        """Fresh baselines after a wholesale rebuild: no consumer has
        committed the new tokens, so every cache full-diffs once."""
        for ch in self._channels.values():
            ch.reset()

    def channel(self, name: str) -> _DirtChannel:
        """The named channel, created on first use. A fresh channel's
        token has never been committed by its consumer, so the first
        drain forces that consumer through its full-build path."""
        ch = self._channels.get(name)
        if ch is None:
            ch = _DirtChannel()
            self._channels[name] = ch
        return ch

    def _mark(self, idx: int):
        cap = self._dirty_cap
        for ch in self._channels.values():
            if ch.dirty_all:
                continue
            ch.dirty.add(idx)
            if len(ch.dirty) > cap:
                ch.dirty_all = True
                ch.dirty = set()

    def _mark_span(self, start: int, stop: int):
        cap = self._dirty_cap
        for ch in self._channels.values():
            if ch.dirty_all:
                continue
            if stop - start > cap or len(ch.dirty) + (stop - start) > cap:
                ch.dirty_all = True
                ch.dirty = set()
            else:
                ch.dirty.update(range(start, stop))

    def _mark_bulk(self, indices, exclude_channel: str | None = None):
        """Record a (possibly huge) batch of dirty indices from a
        vectorized store. `indices` is a numpy int array. The writer may
        exclude its own channel: it already holds the stored values, so
        marking itself would only trigger a redundant re-read."""
        cap = self._dirty_cap
        count = int(indices.size)
        listed = None
        for name, ch in self._channels.items():
            if name == exclude_channel or ch.dirty_all:
                continue
            if count > cap or len(ch.dirty) + count > cap:
                ch.dirty_all = True
                ch.dirty = set()
            else:
                if listed is None:
                    listed = indices.tolist()
                ch.dirty.update(listed)

    def drain_dirty(self, channel: str = HASH_CHANNEL):
        """Consume the channel's pending dirty set and advance its
        baseline.

        Returns (base_token, indices | None): `indices` is None when the
        channel overflowed (treat as everything-dirty). After the call
        the channel's token is fresh — read it via `dirt_token` /
        `dirt_token_for` to record the commit point.
        """
        ch = self.channel(channel)
        base = ch.token
        indices = None if ch.dirty_all else ch.dirty
        ch.dirty = set()
        ch.dirty_all = False
        ch.token = object()
        return base, indices

    @property
    def dirt_token(self):
        return self._channels[HASH_CHANNEL].token

    def dirt_token_for(self, channel: str):
        return self.channel(channel).token


def _fold_values(values, depth: int) -> bytes:
    """Pack uint64s into 32-byte chunks and fold to a subtree root at
    `depth`, zero-padding absent chunks — the ONE definition of this
    Merkleization (block memos and sub-block list types both use it)."""
    data = b"".join(v.to_bytes(8, "little") for v in values)
    if len(data) % 32:
        data += b"\x00" * (32 - len(data) % 32)
    nodes = [data[i : i + 32] for i in range(0, len(data), 32)] or [
        ZERO_HASHES[0]
    ]
    for level in range(depth):
        if len(nodes) % 2:
            nodes.append(ZERO_HASHES[level])
        nodes = [
            hashlib.sha256(nodes[i] + nodes[i + 1]).digest()
            for i in range(0, len(nodes), 2)
        ]
    return nodes[0]


class _Block:
    __slots__ = ("items", "root")

    def __init__(self, items: list[int]):
        self.items = items
        self.root: bytes | None = None

    def subtree_root(self) -> bytes:
        """Root of this block's depth-10 subtree (zero-padded)."""
        if self.root is None:
            self.root = _fold_values(self.items, _BLOCK_DEPTH)
        return self.root


class PersistentList(_DirtyTracking):
    __slots__ = ("_blocks", "_owned", "_channels")

    def __init__(self, values=()):
        vals = [self._coerce(v) for v in values]
        self._blocks = [
            _Block(vals[i : i + BLOCK_ELEMS])
            for i in range(0, len(vals), BLOCK_ELEMS)
        ]
        self._owned = [True] * len(self._blocks)
        self._init_dirt()

    @staticmethod
    def _coerce(v) -> int:
        v = int(v)
        if not 0 <= v <= _U64_MAX:
            raise ValueError(f"uint64 out of range: {v}")
        return v

    # -- structural sharing ---------------------------------------------

    def copy(self) -> "PersistentList":
        """O(#blocks): share every block; neither side may mutate a
        shared block in place afterwards (copy-on-write)."""
        out = PersistentList.__new__(PersistentList)
        out._blocks = list(self._blocks)
        out._owned = [False] * len(self._blocks)
        self._owned = [False] * len(self._blocks)
        self._copy_dirt_to(out)  # same baseline, same pending dirt
        return out

    def _own(self, bi: int) -> _Block:
        """Block bi, cloned first if shared (the CoW write barrier)."""
        blk = self._blocks[bi]
        if not self._owned[bi]:
            blk = _Block(list(blk.items))
            self._blocks[bi] = blk
            self._owned[bi] = True
        blk.root = None
        return blk

    def shared_block_count(self, other: "PersistentList") -> int:
        """How many blocks two lists share (introspection for tests)."""
        mine = {id(b) for b in self._blocks}
        return sum(1 for b in other._blocks if id(b) in mine)

    # -- list surface ----------------------------------------------------

    def __len__(self) -> int:
        if not self._blocks:
            return 0
        return (len(self._blocks) - 1) * BLOCK_ELEMS + len(
            self._blocks[-1].items
        )

    def __iter__(self):
        for blk in self._blocks:
            yield from blk.items

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self)[idx]
        n = len(self)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(idx)
        return self._blocks[idx // BLOCK_ELEMS].items[idx % BLOCK_ELEMS]

    def __setitem__(self, idx, value):
        if isinstance(idx, slice):
            self._assign_slice(idx, value)
            return
        n = len(self)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(idx)
        v = self._coerce(value)
        bi, off = divmod(idx, BLOCK_ELEMS)
        if self._blocks[bi].items[off] != v:
            self._own(bi).items[off] = v
            self._mark(idx)

    def _assign_slice(self, sl: slice, values):
        n = len(self)
        start, stop, step = sl.indices(n)
        vals = [self._coerce(v) for v in values]
        if step != 1 or (stop - start) != len(vals):
            # general path: rare in consensus code; rebuild
            all_vals = list(self)
            all_vals[sl] = vals
            fresh = PersistentList(all_vals)
            self._blocks = fresh._blocks
            self._owned = fresh._owned
            self._reset_dirt()  # wholesale rebuild: fresh hash baseline
            return
        # contiguous same-length assignment (the epoch sweep's
        # `balances[:] = ...`): touch only blocks whose contents change,
        # preserving the root memos of untouched shared blocks
        i = start
        vi = 0
        while i < stop:
            bi, off = divmod(i, BLOCK_ELEMS)
            blk = self._blocks[bi]
            span = min(len(blk.items) - off, stop - i)
            new = vals[vi : vi + span]
            if blk.items[off : off + span] != new:
                self._own(bi).items[off : off + span] = new
                self._mark_span(i, i + span)
            i += span
            vi += span

    def append(self, value):
        v = self._coerce(value)
        if self._blocks and len(self._blocks[-1].items) < BLOCK_ELEMS:
            self._own(len(self._blocks) - 1).items.append(v)
        else:
            self._blocks.append(_Block([v]))
            self._owned.append(True)
        self._mark(len(self) - 1)

    def __eq__(self, other):
        if isinstance(other, (PersistentList, list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented

    def __repr__(self):
        n = len(self)
        head = ", ".join(str(v) for v in self[: min(4, n)])
        return f"PersistentList(len={n}, [{head}{', …' if n > 4 else ''}])"

    # -- hashing ----------------------------------------------------------

    def to_chunk_array(self):
        """Pack the whole list into an SSZ leaf matrix: [⌈n/4⌉, 32] uint8
        (little-endian uint64 packing). The full-extraction path of the
        state-level caches; dirty-index updates avoid this entirely."""
        import numpy as np

        n = len(self)
        n_chunks = (n + 3) // 4
        buf = np.zeros(n_chunks * 4, dtype=np.uint64)
        pos = 0
        for blk in self._blocks:
            buf[pos : pos + len(blk.items)] = np.asarray(
                blk.items, dtype=np.uint64
            )
            pos += len(blk.items)
        return buf.view(np.uint8).reshape(-1, 32)  # little-endian hosts

    # -- bulk numpy interchange (the resident-columns fast path) -----------

    def load_array(self):
        """The whole list as a [n] uint64 array — one C-speed conversion
        per block instead of a per-element Python iteration. Under
        LIGHTHOUSE_TPU_SANITIZE=1 the returned array is a read-only
        guarded view: an escaped consumer that writes it (instead of
        committing through `store_array`) raises a counted sanitizer
        violation at the write site."""
        import numpy as np

        out = np.empty(len(self), dtype=np.uint64)
        pos = 0
        for blk in self._blocks:
            out[pos : pos + len(blk.items)] = blk.items
            pos += len(blk.items)
        from ..analysis.sanitizer import guard

        return guard(out)

    def store_array(self, new, changed=None, exclude_channel=None) -> int:
        """Bulk same-length store from a [n] uint64 array.

        Only elements at `changed` (sorted int indices; computed by a
        vectorized diff against the current contents when omitted) are
        written and dirty-marked, so untouched shared blocks keep their
        root memos and the hash caches see an exact delta. A writer that
        mirrors the list (registry columns) passes its own channel as
        `exclude_channel` — it already holds the stored values. Returns
        the number of elements written.
        """
        import numpy as np

        n = len(self)
        new = np.ascontiguousarray(new, dtype=np.uint64)
        if new.size != n:
            raise ValueError(f"store_array length {new.size} != {n}")
        if changed is None:
            changed = np.nonzero(self.load_array() != new)[0]
        if changed.size == 0:
            return 0
        pos = 0
        ci = 0
        for bi in range(len(self._blocks)):
            blen = len(self._blocks[bi].items)
            hi = int(np.searchsorted(changed, pos + blen))
            if hi > ci:
                blk = self._own(bi)
                span = changed[ci:hi]
                if span.size > blen // 4:
                    # dense in this block: one slice-assign beats
                    # per-index writes (tolist is a C conversion)
                    blk.items[:] = new[pos : pos + blen].tolist()
                else:
                    vals = new[span].tolist()
                    offs = (span - pos).tolist()
                    for off, v in zip(offs, vals):
                        blk.items[off] = v
                ci = hi
            pos += blen
        self._mark_bulk(changed, exclude_channel)
        return int(changed.size)

    def hash_tree_root(self, limit_chunks: int) -> bytes:
        """Merkle root over the list's chunks zero-extended to
        `limit_chunks` (no length mix — the SSZ List type mixes it). Cost:
        re-hash of dirty blocks + a fold over #blocks."""
        total_depth = (limit_chunks - 1).bit_length() if limit_chunks > 1 else 0
        if total_depth < _BLOCK_DEPTH:
            # list type smaller than one block: the depth-10 block memo
            # frame doesn't apply — fold at the type's true depth
            # (clamping to _BLOCK_DEPTH would silently produce a non-SSZ
            # root)
            return _fold_values(list(self), total_depth)
        roots = [blk.subtree_root() for blk in self._blocks]
        return _fold_roots(roots, _BLOCK_DEPTH, total_depth)


def _fold_roots(roots: list[bytes], level: int, total_depth: int) -> bytes:
    """Fold subtree roots (each at `level`) up to `total_depth`."""
    if not roots:
        roots = [ZERO_HASHES[level]]
    while level < total_depth:
        if len(roots) % 2:
            roots.append(ZERO_HASHES[level])
        roots = [
            hash32_concat(roots[i], roots[i + 1])
            for i in range(0, len(roots), 2)
        ]
        level += 1
    return roots[0]


# ---------------------------------------------------------------------------
# Persistent byte list (participation flags: List[uint8] packed 32/chunk)
# ---------------------------------------------------------------------------

BYTE_BLOCK = 8192  # uint8 elements per block = 256 chunks = a depth-8 subtree
_BYTE_CHUNKS_PER_BLOCK = BYTE_BLOCK // 32  # 256
_BYTE_BLOCK_DEPTH = (_BYTE_CHUNKS_PER_BLOCK - 1).bit_length()  # 8


def _fold_bytes(data: bytes, depth: int) -> bytes:
    """Pack raw bytes into 32-byte chunks and fold to a subtree root at
    `depth`, zero-padding absent chunks (the byte-list analog of
    `_fold_values`)."""
    if len(data) % 32:
        data = bytes(data) + b"\x00" * (32 - len(data) % 32)
    nodes = [data[i : i + 32] for i in range(0, len(data), 32)] or [
        ZERO_HASHES[0]
    ]
    for level in range(depth):
        if len(nodes) % 2:
            nodes.append(ZERO_HASHES[level])
        nodes = [
            hashlib.sha256(nodes[i] + nodes[i + 1]).digest()
            for i in range(0, len(nodes), 2)
        ]
    return nodes[0]


class _BBlock:
    __slots__ = ("items", "root")

    def __init__(self, items: bytearray):
        self.items = items
        self.root: bytes | None = None

    def subtree_root(self) -> bytes:
        if self.root is None:
            self.root = _fold_bytes(bytes(self.items), _BYTE_BLOCK_DEPTH)
        return self.root


class PersistentByteList(_DirtyTracking):
    """Structurally-shared List[uint8] — the persistent representation of
    the altair participation-flag lists (ssz/core.py ParticipationList).

    Same contract as PersistentList (the balances backbone): O(#blocks)
    `copy()` with copy-on-write blocks, per-block subtree-root memos,
    per-channel dirty-index tracking (element == byte index) so BOTH the
    tree-hash caches and the resident registry columns consume exact
    deltas, and `load_array`/`store_array` bulk numpy interchange for the
    vectorized attestation pipeline. Mutation surface: indexing, item
    assignment, `append`, iteration, `len`, `bytes()`, equality against
    any bytes-like."""

    __slots__ = ("_blocks", "_owned", "_channels")

    def __init__(self, values=b""):
        data = bytearray(values)
        self._blocks = [
            _BBlock(data[i : i + BYTE_BLOCK])
            for i in range(0, len(data), BYTE_BLOCK)
        ]
        self._owned = [True] * len(self._blocks)
        self._init_dirt()

    @staticmethod
    def _coerce(v) -> int:
        v = int(v)
        if not 0 <= v <= 255:
            raise ValueError(f"uint8 out of range: {v}")
        return v

    # -- structural sharing ---------------------------------------------

    def copy(self) -> "PersistentByteList":
        out = PersistentByteList.__new__(PersistentByteList)
        out._blocks = list(self._blocks)
        out._owned = [False] * len(self._blocks)
        self._owned = [False] * len(self._blocks)
        self._copy_dirt_to(out)  # same baseline, same pending dirt
        return out

    def _own(self, bi: int) -> _BBlock:
        blk = self._blocks[bi]
        if not self._owned[bi]:
            blk = _BBlock(bytearray(blk.items))
            self._blocks[bi] = blk
            self._owned[bi] = True
        blk.root = None
        return blk

    def shared_block_count(self, other: "PersistentByteList") -> int:
        mine = {id(b) for b in self._blocks}
        return sum(1 for b in other._blocks if id(b) in mine)

    # -- list / bytes surface --------------------------------------------

    def __len__(self) -> int:
        if not self._blocks:
            return 0
        return (len(self._blocks) - 1) * BYTE_BLOCK + len(
            self._blocks[-1].items
        )

    def __iter__(self):
        for blk in self._blocks:
            yield from blk.items

    def __bytes__(self) -> bytes:
        return b"".join(bytes(blk.items) for blk in self._blocks)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return bytes(self)[idx]
        n = len(self)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(idx)
        return self._blocks[idx // BYTE_BLOCK].items[idx % BYTE_BLOCK]

    def __setitem__(self, idx, value):
        n = len(self)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(idx)
        v = self._coerce(value)
        bi, off = divmod(idx, BYTE_BLOCK)
        if self._blocks[bi].items[off] != v:
            self._own(bi).items[off] = v
            self._mark(idx)

    def append(self, value):
        v = self._coerce(value)
        if self._blocks and len(self._blocks[-1].items) < BYTE_BLOCK:
            self._own(len(self._blocks) - 1).items.append(v)
        else:
            self._blocks.append(_BBlock(bytearray([v])))
            self._owned.append(True)
        self._mark(len(self) - 1)

    def __eq__(self, other):
        if isinstance(
            other, (PersistentByteList, bytes, bytearray, list, tuple)
        ):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented

    def __repr__(self):
        n = len(self)
        return f"PersistentByteList(len={n}, {bytes(self)[:8].hex()}…)"

    # -- bulk numpy interchange (the attestation-pipeline fast path) ------

    def load_array(self):
        """The whole list as a [n] uint8 array (read-only guarded view
        under LIGHTHOUSE_TPU_SANITIZE=1 — the PersistentList contract)."""
        import numpy as np

        out = np.empty(len(self), dtype=np.uint8)
        pos = 0
        for blk in self._blocks:
            out[pos : pos + len(blk.items)] = np.frombuffer(
                blk.items, dtype=np.uint8
            )
            pos += len(blk.items)
        from ..analysis.sanitizer import guard

        return guard(out)

    def store_array(self, new, changed=None, exclude_channel=None) -> int:
        """Bulk same-length store from a [n] uint8 array; only elements at
        `changed` (vectorized diff when omitted) are written and
        dirty-marked — the PersistentList.store_array contract."""
        import numpy as np

        n = len(self)
        new = np.ascontiguousarray(new, dtype=np.uint8)
        if new.size != n:
            raise ValueError(f"store_array length {new.size} != {n}")
        if changed is None:
            changed = np.nonzero(self.load_array() != new)[0]
        if changed.size == 0:
            return 0
        pos = 0
        ci = 0
        for bi in range(len(self._blocks)):
            blen = len(self._blocks[bi].items)
            hi = int(np.searchsorted(changed, pos + blen))
            if hi > ci:
                blk = self._own(bi)
                span = changed[ci:hi]
                if span.size > blen // 4:
                    blk.items[:] = new[pos : pos + blen].tobytes()
                else:
                    vals = new[span].tolist()
                    offs = (span - pos).tolist()
                    for off, v in zip(offs, vals):
                        blk.items[off] = v
                ci = hi
            pos += blen
        self._mark_bulk(changed, exclude_channel)
        return int(changed.size)

    # -- hashing ----------------------------------------------------------

    def to_chunk_matrix(self):
        """The whole list as an SSZ leaf matrix [⌈n/32⌉, 32] uint8 (the
        full-extraction path of the state-level caches)."""
        import numpy as np

        n = len(self)
        n_chunks = (n + 31) // 32
        buf = np.zeros(n_chunks * 32, dtype=np.uint8)
        buf[:n] = self.load_array()
        return buf.reshape(-1, 32)

    def chunk_rows(self, chunk_idx):
        """[m, 32] leaf rows for the given chunk indices (zero-padded
        tail) — the sparse-update gather. A chunk never crosses a block
        boundary (BYTE_BLOCK % 32 == 0)."""
        import numpy as np

        n = len(self)
        m = len(chunk_idx)
        rows = np.zeros((m, 32), dtype=np.uint8)
        for r, c in enumerate(chunk_idx):
            lo = int(c) * 32
            span = min(32, n - lo)
            bi, off = divmod(lo, BYTE_BLOCK)
            rows[r, :span] = np.frombuffer(
                self._blocks[bi].items, dtype=np.uint8, count=span, offset=off
            )
        return rows

    def hash_tree_root(self, limit_chunks: int) -> bytes:
        """Merkle root over the list's chunks zero-extended to
        `limit_chunks` (no length mix — the SSZ type mixes it)."""
        total_depth = (limit_chunks - 1).bit_length() if limit_chunks > 1 else 0
        if total_depth < _BYTE_BLOCK_DEPTH:
            return _fold_bytes(bytes(self), total_depth)
        roots = [blk.subtree_root() for blk in self._blocks]
        return _fold_roots(roots, _BYTE_BLOCK_DEPTH, total_depth)


# ---------------------------------------------------------------------------
# Persistent container list (the milhouse `List<Validator>` analog)
# ---------------------------------------------------------------------------

CONTAINER_BLOCK = 256  # elements per block = a depth-8 subtree of roots
_CONTAINER_DEPTH = (CONTAINER_BLOCK - 1).bit_length()  # 8


def _elem_root(v) -> bytes:
    """Element container root, memoized on the object (`_thc_root`;
    Container.__setattr__ clears it — cached_tree_hash.rs's per-leaf memo)."""
    root = v.__dict__.get("_thc_root")
    if root is None:
        root = type(v).hash_tree_root_of(v)
        v.__dict__["_thc_root"] = root
    return root


class _CBlock:
    __slots__ = ("items", "root")

    def __init__(self, items: list):
        self.items = items
        self.root: bytes | None = None

    def subtree_root(self) -> bytes:
        if self.root is None:
            self.root = _fold_root_chunks(
                [_elem_root(v) for v in self.items]
            )
        return self.root


def _fold_root_chunks(roots: list[bytes]) -> bytes:
    import hashlib as _h

    nodes = roots or [ZERO_HASHES[0]]
    for level in range(_CONTAINER_DEPTH):
        if len(nodes) % 2:
            nodes.append(ZERO_HASHES[level])
        nodes = [
            _h.sha256(nodes[i] + nodes[i + 1]).digest()
            for i in range(0, len(nodes), 2)
        ]
    return nodes[0]


class PersistentContainerList(_DirtyTracking):
    """Structurally-shared list of SSZ Container elements — the milhouse
    `List<Validator>` backbone (consensus/types/src/beacon_state.rs:34,371):
    `copy()` is O(#blocks); per-element root memos + per-block subtree
    memos make re-roots O(dirty); bulk (cold) builds vectorize element
    roots columnar instead of one Python `hash_tree_root_of` per element.

    MUTATION CONTRACT (enforced): elements inside the list are frozen —
    direct field writes raise `FrozenElementError` (the milhouse `&mut`
    discipline, checked at write time instead of by convention). Replace
    via `lst[i] = v`, or get a write-safe clone with `lst.mutate(i)`
    (installs the clone, busts the memos, returns it for in-place field
    writes). Clones handed out by `mutate()` stay writable until the
    list is next copied, at which point they are re-frozen (the block
    becomes shared again)."""

    __slots__ = ("_blocks", "_owned", "elem_t", "_thawed", "_channels")

    # Exact dirty indices stay profitable far past the uint64 lists'
    # threshold: each container element costs 7 batched hashes plus a
    # Python field extraction to re-root, so even a third of a 1M
    # registry (an epoch-boundary effective-balance sweep) is cheaper as
    # a 333k-row sparse update than as a full columnar rebuild.
    _dirty_cap = 1 << 20

    def __init__(self, values=(), elem_t=None):
        vals = list(values)
        if elem_t is None and vals:
            elem_t = type(vals[0])
        self.elem_t = elem_t
        self._blocks = [
            _CBlock(vals[i : i + CONTAINER_BLOCK])
            for i in range(0, len(vals), CONTAINER_BLOCK)
        ]
        self._owned = [True] * len(self._blocks)
        self._thawed = []
        for v in vals:
            v.__dict__["_frozen"] = True
        self._init_dirt()

    # -- structural sharing ---------------------------------------------

    def copy(self) -> "PersistentContainerList":
        # re-freeze the clones mutate() handed out: their blocks are about
        # to be shared, so further direct writes would corrupt both sides
        for v in self._thawed:
            v.__dict__["_frozen"] = True
        self._thawed = []
        out = PersistentContainerList.__new__(PersistentContainerList)
        out.elem_t = self.elem_t
        out._blocks = list(self._blocks)
        out._owned = [False] * len(self._blocks)
        out._thawed = []
        self._owned = [False] * len(self._blocks)
        self._copy_dirt_to(out)  # same baseline, same pending dirt
        return out

    def _own(self, bi: int) -> _CBlock:
        blk = self._blocks[bi]
        if not self._owned[bi]:
            blk = _CBlock(list(blk.items))
            self._blocks[bi] = blk
            self._owned[bi] = True
        blk.root = None
        return blk

    def shared_block_count(self, other: "PersistentContainerList") -> int:
        mine = {id(b) for b in self._blocks}
        return sum(1 for b in other._blocks if id(b) in mine)

    # -- list surface ----------------------------------------------------

    def __len__(self) -> int:
        if not self._blocks:
            return 0
        return (len(self._blocks) - 1) * CONTAINER_BLOCK + len(
            self._blocks[-1].items
        )

    def __iter__(self):
        for blk in self._blocks:
            yield from blk.items

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self)[idx]
        n = len(self)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(idx)
        return self._blocks[idx // CONTAINER_BLOCK].items[idx % CONTAINER_BLOCK]

    def __setitem__(self, idx, value):
        n = len(self)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(idx)
        bi, off = divmod(idx, CONTAINER_BLOCK)
        value.__dict__["_frozen"] = True
        self._own(bi).items[off] = value
        self._mark(idx)

    def mutate(self, idx):
        """Write-safe element access: installs a clone of element `idx`
        (busting the root memos) and returns it for field mutation.
        The clone is writable until this list is next copied."""
        n = len(self)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(idx)
        bi, off = divmod(idx, CONTAINER_BLOCK)
        blk = self._own(bi)
        v = blk.items[off].copy()  # Container.copy() drops _frozen
        v.__dict__.pop("_thc_root", None)
        blk.items[off] = v
        self._thawed.append(v)
        self._mark(idx)  # conservatively dirty: the clone exists to be written
        return v

    def drain_dirty(self, channel: str = HASH_CHANNEL):
        # A consumer is committing a snapshot (hash root OR column
        # mirror) over the current contents: re-freeze the clones
        # mutate() handed out. A later write through a stale handle
        # would be invisible to the drained delta (the committed
        # snapshot would silently diverge) — raising FrozenElementError
        # forces the writer back through mutate().
        for v in self._thawed:
            v.__dict__["_frozen"] = True
        self._thawed = []
        return super().drain_dirty(channel)

    def set_fields_bulk(self, indices, field: str, values):
        """Bulk single-field writeback: replace element `i` with a
        shallow clone carrying ``field=value`` for every (i, value) pair.

        The epoch sweeps (hysteresis effective-balance updates, registry
        eligibility/activation stores) write ONE field across many rows;
        routing each through `mutate()` costs a full container deep-copy
        per row (the r05 epoch-boundary bottleneck). Element fields are
        immutable scalars/bytes (the Validator shape), so a `__dict__`
        copy is an exact clone; the root memo is dropped, the clone is
        installed frozen (no thaw handle to leak), and the dirty marks
        land as one bulk batch.
        """
        import numpy as np

        n = len(self)
        blk = None
        cur_bi = -1
        for idx, val in zip(indices, values):
            if not 0 <= idx < n:
                raise IndexError(idx)
            bi, off = divmod(idx, CONTAINER_BLOCK)
            if bi != cur_bi:
                blk = self._own(bi)
                cur_bi = bi
            v = blk.items[off]
            cls = type(v)
            new = cls.__new__(cls)
            nd = new.__dict__
            nd.update(v.__dict__)
            nd.pop("_thc_root", None)
            nd[field] = cls._fields[field].coerce(val)
            nd["_frozen"] = True
            blk.items[off] = new
        self._mark_bulk(np.asarray(list(indices), dtype=np.int64))

    def append(self, value):
        value.__dict__["_frozen"] = True
        if self._blocks and len(self._blocks[-1].items) < CONTAINER_BLOCK:
            self._own(len(self._blocks) - 1).items.append(value)
        else:
            self._blocks.append(_CBlock([value]))
            self._owned.append(True)
        self._mark(len(self) - 1)

    def __eq__(self, other):
        if isinstance(other, (PersistentContainerList, list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented

    def __repr__(self):
        return (
            f"PersistentContainerList(len={len(self)}, "
            f"elem={getattr(self.elem_t, '__name__', None)})"
        )

    # -- hashing ----------------------------------------------------------

    def hash_tree_root(self, limit_chunks: int) -> bytes:
        total_depth = (limit_chunks - 1).bit_length() if limit_chunks > 1 else 0
        if total_depth < _CONTAINER_DEPTH:
            import hashlib as _h

            nodes = [_elem_root(v) for v in self] or [ZERO_HASHES[0]]
            for level in range(total_depth):
                if len(nodes) % 2:
                    nodes.append(ZERO_HASHES[level])
                nodes = [
                    _h.sha256(nodes[i] + nodes[i + 1]).digest()
                    for i in range(0, len(nodes), 2)
                ]
            return nodes[0]
        self._bulk_build_missing()
        roots = [blk.subtree_root() for blk in self._blocks]
        return _fold_roots(roots, _CONTAINER_DEPTH, total_depth)

    def _bulk_build_missing(self):
        """Vectorized cold path: compute memo-less element roots columnar
        (one numpy pass per field + batched SHA-256) instead of per-element
        Python Merkleization. Kicks in for big rebuilds only."""
        pending = [
            v
            for blk in self._blocks
            if blk.root is None
            for v in blk.items
            if "_thc_root" not in v.__dict__
        ]
        if len(pending) < 2 * CONTAINER_BLOCK:
            return  # per-element path is fine at this size
        bulk_container_roots(pending)


def bulk_container_roots(elems: list) -> None:
    """Compute `_thc_root` for every element in one columnar pass.

    Requires a fixed-size container whose fields are basic uints, boolean,
    or ByteVector — the Validator shape. Falls back silently (memos left
    unset) for other shapes; callers then pay the per-element path.
    The columnar extraction + batched subtree fold is the shared
    implementation in ssz/cached_tree_hash.py."""
    from .cached_tree_hash import container_roots_columnar

    if not elems:
        return
    roots = container_roots_columnar(type(elems[0]), elems)
    if roots is None:
        return  # unsupported shape: leave memos unset
    for i, v in enumerate(elems):
        v.__dict__["_thc_root"] = roots[i].tobytes()
