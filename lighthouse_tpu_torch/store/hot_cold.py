"""HotColdDB: typed block/state storage over the KV trait.

Mirrors beacon_node/store/src/hot_cold_store.rs:50-55: hot (recent,
unfinalized) data separate from cold (finalized history), split at the
finalization boundary; states in the hot DB carry summaries, cold states are
reconstructable from restore points. The hot side + split bookkeeping live
here; the finality-driven migration cycle, periodic cold restore-point
snapshots, and snapshot+replay reconstruction of intermediate cold states
(store/src/reconstruct.rs) live in `store/migrator.py`."""

from __future__ import annotations

from ..types.chain_spec import ForkName
from .kv import DBColumn, ItemStore, MemoryStore

SPLIT_KEY = b"split"
HEAD_KEY = b"head"
GENESIS_KEY = b"genesis"
FORK_CHOICE_KEY = b"fork_choice"
SCHEMA_VERSION_KEY = b"schema"
# anchor watermark: slot (8B LE) || anchor block root (32B) || anchor state
# root (32B) — written at boot (genesis or checkpoint) and re-pointed at the
# finalized checkpoint by every migration cycle, so a restart can re-anchor
# on the newest finalized state instead of replaying from genesis
ANCHOR_INFO_KEY = b"anchor_info"

# On-disk schema version (store/src/lib.rs CURRENT_SCHEMA_VERSION analog).
# Bump on any layout change; `open` detects mismatches so a migration (or a
# refusal to run) happens instead of silent misreads.
# v2: BLOB_SIDECARS values gained an 8-byte slot prefix
CURRENT_SCHEMA_VERSION = 2

# Stable 1-byte fork tags prefixed to stored states/blocks so decode picks
# the right SSZ variant (the reference keys this off slot + spec; an explicit
# tag keeps the store self-describing). Append-only list.
_FORK_TAGS = [
    ForkName.PHASE0,
    ForkName.ALTAIR,
    ForkName.BELLATRIX,
    ForkName.CAPELLA,
    ForkName.DENEB,
    ForkName.ELECTRA,
]
_TAG_OF_FORK = {f: i for i, f in enumerate(_FORK_TAGS)}


class StoreError(ValueError):
    pass


class SchemaVersionError(StoreError):
    pass


class HotColdDB:
    def __init__(self, hot: ItemStore, cold: ItemStore | None = None, types=None):
        self.hot = hot
        self.cold = cold if cold is not None else MemoryStore()
        self.types = types  # SimpleNamespace from build_types, for SSZ codecs
        self._split_slot = 0
        # slot-keyed DA retention index: DBColumn -> {slot: set(block_root)},
        # built lazily from the stored slot prefixes on first expiry query,
        # maintained by every put/delete after that — pruning walks only
        # expired slots instead of rescanning every entry
        self._da_index: dict = {}
        # store generation: bumped after every migration/prune batch so
        # concurrent readers (API tier indexes, sidecar serving) can detect
        # that a batch ran mid-read and retry against a settled view
        self._generation = 0
        self._check_schema_version()

    def _check_schema_version(self):
        raw = self.hot.get(DBColumn.BEACON_META, SCHEMA_VERSION_KEY)
        if raw is None:
            # Stamp only a genuinely fresh store. A populated store with no
            # version key predates schema tagging — refuse instead of
            # misreading its untagged values.
            if self.hot.keys(DBColumn.BEACON_BLOCK) or self.hot.keys(
                DBColumn.BEACON_STATE
            ):
                raise SchemaVersionError(
                    "store has data but no schema version key (pre-v1 "
                    "layout) — run the database manager migration"
                )
            self.hot.put(
                DBColumn.BEACON_META,
                SCHEMA_VERSION_KEY,
                CURRENT_SCHEMA_VERSION.to_bytes(8, "little"),
            )
            return
        found = int.from_bytes(raw, "little")
        if found != CURRENT_SCHEMA_VERSION:
            raise SchemaVersionError(
                f"on-disk schema v{found} != supported v{CURRENT_SCHEMA_VERSION}"
                " — run the database manager migration"
            )

    # -- fork-tagged SSZ codecs ---------------------------------------------

    def _encode(self, obj, fork: ForkName) -> bytes:
        return bytes([_TAG_OF_FORK[fork]]) + obj.serialize()

    def _decode(self, data: bytes, kind: str):
        tag = data[0]
        if tag >= len(_FORK_TAGS):
            raise StoreError(f"unknown fork tag {tag}")
        tf = self.types.types_for_fork(_FORK_TAGS[tag])
        return getattr(tf, kind).deserialize(data[1:])

    # -- blocks ------------------------------------------------------------

    def put_block(self, block_root: bytes, signed_block):
        fork = self.types.fork_of_block(signed_block.message)
        self.hot.put(
            DBColumn.BEACON_BLOCK,
            block_root,
            self._encode(signed_block, fork),
        )

    def get_block(self, block_root: bytes):
        data = self.hot.get(DBColumn.BEACON_BLOCK, block_root)
        if data is None:
            data = self.cold.get(DBColumn.BEACON_BLOCK, block_root)
        if data is None:
            return None
        return self._decode(data, "SignedBeaconBlock")

    def hot_blocks(self) -> list:
        """Decode every hot (unfinalized) block as (root, signed_block) —
        the restart path re-imports these to rebuild fork choice above the
        persisted anchor."""
        out = []
        for root in self.hot.keys(DBColumn.BEACON_BLOCK):
            data = self.hot.get(DBColumn.BEACON_BLOCK, root)
            if data is not None:
                out.append((root, self._decode(data, "SignedBeaconBlock")))
        return out

    def delete_block(self, block_root: bytes):
        """Hot-only deletion (fork_revert wipes unfinalized segments;
        cold blocks are finalized and must never be deleted)."""
        self.hot.delete(DBColumn.BEACON_BLOCK, block_root)

    # -- blob sidecars (Deneb DA history; served via BlobsByRange/Root) ----

    def put_blob_sidecars(self, block_root: bytes, sidecars: list):
        """All of one block's verified sidecars under its root (the
        reference stores the sidecar list per block in its blobs DB).
        BlobSidecar has a single fork-independent layout — length-prefixed
        concat, no fork tag."""
        if not sidecars:
            return
        # 8-byte slot prefix: retention expiry reads ONLY this (never a
        # block or sidecar decode)
        slot = int(sidecars[0].signed_block_header.message.slot)
        parts = [slot.to_bytes(8, "little")]
        for sc in sidecars:
            data = sc.serialize()
            parts.append(len(data).to_bytes(4, "little") + data)
        self._da_put(DBColumn.BLOB_SIDECARS, block_root, slot, b"".join(parts))

    def delete_blob_sidecars(self, block_root: bytes):
        self._da_delete(DBColumn.BLOB_SIDECARS, block_root)

    def blob_sidecar_entries(self) -> list[tuple[bytes, int]]:
        """(block_root, slot) per stored sidecar set — slot from the
        8-byte prefix, no SSZ decode."""
        return self._da_entries(DBColumn.BLOB_SIDECARS)

    def blob_sidecar_entries_before(self, cutoff_slot: int) -> list[tuple[bytes, int]]:
        """(block_root, slot) for sidecar sets with slot < cutoff — via the
        slot index, touching only expired entries (never a full scan)."""
        return self._da_entries_before(DBColumn.BLOB_SIDECARS, cutoff_slot)

    # -- slot-keyed DA retention index (shared by blobs and data columns) --

    def _da_index_for(self, column: DBColumn) -> dict:
        idx = self._da_index.get(column)
        if idx is None:
            # one-time build from the stored slot prefixes (pre-existing
            # DBs); every subsequent put/delete maintains it incrementally
            idx = {}
            for root in self.hot.keys(column):
                prefix = self.hot.get_prefix(column, root, 8)
                if prefix and len(prefix) == 8:
                    slot = int.from_bytes(prefix, "little")
                    idx.setdefault(slot, set()).add(root)
            self._da_index[column] = idx
        return idx

    def _da_put(self, column: DBColumn, block_root: bytes, slot: int, value: bytes):
        idx = self._da_index_for(column)
        old = self.hot.get_prefix(column, block_root, 8)
        if old and len(old) == 8:
            old_slot = int.from_bytes(old, "little")
            if old_slot != slot and old_slot in idx:
                idx[old_slot].discard(block_root)
        self.hot.put(column, block_root, value)
        idx.setdefault(int(slot), set()).add(block_root)

    def _da_delete(self, column: DBColumn, block_root: bytes):
        idx = self._da_index_for(column)
        prefix = self.hot.get_prefix(column, block_root, 8)
        if prefix and len(prefix) == 8:
            slot = int.from_bytes(prefix, "little")
            roots = idx.get(slot)
            if roots is not None:
                roots.discard(block_root)
                if not roots:
                    del idx[slot]
        self.hot.delete(column, block_root)

    def _da_entries(self, column: DBColumn) -> list[tuple[bytes, int]]:
        return [
            (root, slot)
            for slot, roots in self._da_index_for(column).items()
            for root in roots
        ]

    def _da_entries_before(
        self, column: DBColumn, cutoff_slot: int
    ) -> list[tuple[bytes, int]]:
        idx = self._da_index_for(column)
        return [
            (root, slot)
            for slot in sorted(s for s in idx if s < cutoff_slot)
            for root in sorted(idx[slot])
        ]

    # -- data column sidecars (PeerDAS; served via DataColumnsByRange/Root) -

    def put_data_column_sidecars(self, block_root: bytes, sidecars: list):
        """A block's verified DataColumnSidecars under its root — same
        8-byte slot prefix + length-prefixed concat layout as blobs, and
        the same slot-indexed retention."""
        if not sidecars:
            return
        slot = int(sidecars[0].signed_block_header.message.slot)
        parts = [slot.to_bytes(8, "little")]
        for sc in sidecars:
            data = sc.serialize()
            parts.append(len(data).to_bytes(4, "little") + data)
        self._da_put(DBColumn.DATA_COLUMNS, block_root, slot, b"".join(parts))

    def delete_data_column_sidecars(self, block_root: bytes):
        self._da_delete(DBColumn.DATA_COLUMNS, block_root)

    def data_column_entries(self) -> list[tuple[bytes, int]]:
        return self._da_entries(DBColumn.DATA_COLUMNS)

    def data_column_entries_before(self, cutoff_slot: int) -> list[tuple[bytes, int]]:
        return self._da_entries_before(DBColumn.DATA_COLUMNS, cutoff_slot)

    def get_data_column_sidecars(self, block_root: bytes) -> list:
        data = self.hot.get(DBColumn.DATA_COLUMNS, block_root)
        if data is None:
            return []
        out = []
        pos = 8  # skip slot prefix
        while pos < len(data):
            n = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
            out.append(
                self.types.DataColumnSidecar.deserialize(data[pos : pos + n])
            )
            pos += n
        return out

    def get_blob_sidecars(self, block_root: bytes) -> list:
        data = self.hot.get(DBColumn.BLOB_SIDECARS, block_root)
        if data is None:
            return []
        out = []
        pos = 8  # skip slot prefix
        while pos < len(data):
            n = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
            out.append(self.types.BlobSidecar.deserialize(data[pos : pos + n]))
            pos += n
        return out

    def block_exists(self, block_root: bytes) -> bool:
        return self.hot.exists(DBColumn.BEACON_BLOCK, block_root) or self.cold.exists(
            DBColumn.BEACON_BLOCK, block_root
        )

    # -- states ------------------------------------------------------------

    def put_state(self, state_root: bytes, state):
        """Unfinalized state → hot DB (the split invariant: hot holds
        recent states, cold holds restore-point snapshots only)."""
        fork = self.types.fork_of_state(state)
        self.hot.put(
            DBColumn.BEACON_STATE, state_root, self._encode(state, fork)
        )

    def put_cold_state(self, state_root: bytes, state):
        """Finalized restore-point snapshot → cold DB explicitly. The old
        hot-only `put_state` left `get_state`'s cold fallback permanently
        dead for anything the migrator wrote."""
        fork = self.types.fork_of_state(state)
        self.cold.put(
            DBColumn.BEACON_STATE, state_root, self._encode(state, fork)
        )

    def get_state(self, state_root: bytes):
        data = self.hot.get(DBColumn.BEACON_STATE, state_root)
        if data is None:
            data = self.cold.get(DBColumn.BEACON_STATE, state_root)
        if data is None:
            return None
        return self._decode(data, "BeaconState")

    def delete_state(self, state_root: bytes, side: str = "both"):
        """Side-aware deletion. Default removes BOTH copies — a state
        migrated to cold and then deleted must not resurrect through
        `get_state`'s cold fallback. The migrator passes side="hot" when
        it intentionally keeps (or just wrote) a cold snapshot of the
        same root."""
        if side not in ("both", "hot", "cold"):
            raise StoreError(f"unknown state deletion side {side!r}")
        if side in ("both", "hot"):
            self.hot.delete(DBColumn.BEACON_STATE, state_root)
        if side in ("both", "cold"):
            self.cold.delete(DBColumn.BEACON_STATE, state_root)

    # -- metadata ----------------------------------------------------------

    def put_meta(self, key: bytes, value: bytes):
        self.hot.put(DBColumn.BEACON_META, key, value)

    def get_meta(self, key: bytes) -> bytes | None:
        return self.hot.get(DBColumn.BEACON_META, key)

    @property
    def split_slot(self) -> int:
        raw = self.get_meta(SPLIT_KEY)
        return int.from_bytes(raw, "little") if raw else 0

    def set_split_slot(self, slot: int):
        self.put_meta(SPLIT_KEY, slot.to_bytes(8, "little"))

    def put_fork_choice_snapshot(self, snapshot: bytes):
        self.hot.put(DBColumn.FORK_CHOICE, FORK_CHOICE_KEY, snapshot)

    def get_fork_choice_snapshot(self) -> bytes | None:
        return self.hot.get(DBColumn.FORK_CHOICE, FORK_CHOICE_KEY)

    def set_anchor_info(self, slot: int, block_root: bytes, state_root: bytes):
        """Persist the restart anchor: the newest finalized (slot, block
        root, state root) whose state is retrievable from this store."""
        self.put_meta(
            ANCHOR_INFO_KEY,
            int(slot).to_bytes(8, "little") + bytes(block_root) + bytes(state_root),
        )

    def get_anchor_info(self) -> tuple[int, bytes, bytes] | None:
        raw = self.get_meta(ANCHOR_INFO_KEY)
        if raw is None or len(raw) != 72:
            return None
        return int.from_bytes(raw[:8], "little"), raw[8:40], raw[40:72]

    @property
    def generation(self) -> int:
        """Monotonic batch counter for prune-while-serving readers: a
        reader that sees the generation move across its lookup knows a
        migration batch ran underneath it and retries."""
        return self._generation

    def bump_generation(self):
        self._generation += 1

    def column_stats(self) -> dict:
        """Per-side, per-column {keys, bytes} plus split/anchor watermarks
        — the `store` block of `/lighthouse/health` (the oracle asserts
        bounded hot-store size off these numbers). Only columns with at
        least one key are listed, keeping the block small."""
        out: dict = {"split_slot": self.split_slot}
        anchor = self.get_anchor_info()
        out["anchor_slot"] = anchor[0] if anchor else 0
        for side_name, side in (("hot", self.hot), ("cold", self.cold)):
            cols = {}
            total_keys = 0
            total_bytes = 0
            for col in DBColumn:
                count, size = side.stats(col)
                if count:
                    cols[col.name.lower()] = {"keys": count, "bytes": size}
                    total_keys += count
                    total_bytes += size
            out[side_name] = {
                "columns": cols,
                "total_keys": total_keys,
                "total_bytes": total_bytes,
            }
        return out

    # -- migration (beacon_chain/src/migrate.rs analog) ---------------------

    def migrate_to_cold(self, finalized_slot: int, finalized_block_roots):
        """Move finalized blocks hot→cold and advance the split. State
        pruning: hot states strictly before the split are dropped (they are
        reconstructable by replaying blocks from the last kept state)."""
        ops_cold = []
        ops_hot = []
        for root in finalized_block_roots:
            data = self.hot.get(DBColumn.BEACON_BLOCK, root)
            if data is not None:
                ops_cold.append(("put", DBColumn.BEACON_BLOCK, root, data))
                ops_hot.append(("delete", DBColumn.BEACON_BLOCK, root))
        self.cold.do_atomically(ops_cold)
        ops_hot.append(
            ("put", DBColumn.BEACON_META, SPLIT_KEY, finalized_slot.to_bytes(8, "little"))
        )
        self.hot.do_atomically(ops_hot)
        # cold puts land before hot deletes, so get_block never sees a
        # window where a migrated block is on neither side; the bump lets
        # index readers detect the hot→cold handoff mid-scan
        self.bump_generation()
