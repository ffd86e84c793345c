"""Retained scalar slashing-detection engine (differential oracle).

This is the pre-columnar `Slasher` verbatim — per-validator dict
bookkeeping, linear surround scans over `records.values()` — kept as the
differential oracle and bench control for `slasher/columnar.py` (the
reference crate's test strategy: the chunked min/max-span arrays must
emit exactly what a direct interval check emits, in the same order, with
the same strings). `LIGHTHOUSE_TPU_COLUMNAR_SLASHER=0` selects this
engine at the `Slasher` factory.

Epoch/slot arithmetic here predates the safe-arith scope extension to
slasher/ and is kept byte-for-byte as the oracle:
# lint: allow-file(safe-arith) -- retained scalar oracle, kept verbatim
"""

from __future__ import annotations

from dataclasses import dataclass

from ..metrics import inc_counter

DEFAULT_HISTORY_LENGTH = 4096


@dataclass
class _AttRecord:
    source: int
    target: int
    data_root: bytes
    indexed: object  # IndexedAttestation


@dataclass
class _BlockRecord:
    slot: int
    header_root: bytes
    signed_header: object


@dataclass
class SlasherConfig:
    history_length: int = DEFAULT_HISTORY_LENGTH


class ReferenceSlasher:
    def __init__(self, E, config: SlasherConfig | None = None, store=None):
        from ..types.containers import build_types

        self.E = E
        self.config = config or SlasherConfig()
        self._T = build_types(E)
        # validator index -> target epoch -> record (one canonical att per
        # target; a conflicting second one IS the double vote)
        self._atts: dict[int, dict[int, _AttRecord]] = {}
        self._blocks: dict[int, dict[int, _BlockRecord]] = {}
        self._att_queue: list = []
        self._block_queue: list = []
        self.attester_slashings: list = []
        self.proposer_slashings: list = []
        # dedup: re-seen conflicting messages must not re-emit the same
        # slashing into the pool
        self._emitted: set = set()
        # same dedup for double proposals: a conflicting header pair is
        # gossiped repeatedly (every peer relays both sides) and must
        # yield ONE ProposerSlashing, keyed like the attestation path
        self._emitted_blocks: set = set()
        # Optional persistence through the KV trait (the reference backs
        # the slasher with LMDB/MDBX, slasher/src/database/): records are
        # written through in one atomic batch per process_queued() cycle
        # and reloaded on construction, so detection history survives
        # restarts. The _emitted dedup set is rebuilt lazily — a re-found
        # slashing after restart is re-pooled, which is safe (the op pool
        # dedups by content).
        self._store = store
        self._pending_ops: list = []
        # (target, data_root) attestation bodies already written — dedup
        # so each aggregate is stored once, not once per attesting index
        self._indexed_persisted: set[bytes] = set()
        if store is not None:
            self._load_from_store()

    # -- ingestion (slasher service feed) -------------------------------------

    def accept_attestation(self, indexed_attestation):
        self._att_queue.append(indexed_attestation)

    def accept_block_header(self, signed_header):
        self._block_queue.append(signed_header)

    # -- introspection (engine-generic test surface) ---------------------------

    def has_attestation_record(self, vi: int, target: int) -> bool:
        return int(target) in self._atts.get(int(vi), {})

    def attestation_record_count(self) -> int:
        return sum(len(recs) for recs in self._atts.values())

    # -- persistence (LMDB/MDBX analog over the ItemStore trait) ---------------

    @staticmethod
    def _att_key(vi: int, target: int) -> bytes:
        # big-endian so per-validator records are contiguous under scans
        return vi.to_bytes(8, "big") + target.to_bytes(8, "big")

    @staticmethod
    def _blk_key(proposer: int, slot: int) -> bytes:
        return proposer.to_bytes(8, "big") + slot.to_bytes(8, "big")

    @staticmethod
    def _indexed_key(target: int, data_root: bytes) -> bytes:
        # epoch-prefixed so pruning can range over expired targets
        return target.to_bytes(8, "big") + data_root

    def _persist_att(self, vi: int, rec: _AttRecord):
        """Small per-validator record only; the attestation body is stored
        ONCE per (target, data_root) in SLASHER_INDEXED (the reference
        likewise keeps one attestation row referenced by id, not a copy
        per attesting validator)."""
        if self._store is None:
            return
        from ..store.kv import DBColumn

        value = rec.source.to_bytes(8, "little") + rec.data_root
        self._pending_ops.append(
            ("put", DBColumn.SLASHER_ATTESTATION, self._att_key(vi, rec.target), value)
        )

    def _persist_indexed(self, target: int, data_root: bytes, indexed_bytes: bytes):
        if self._store is None:
            return
        from ..store.kv import DBColumn

        key = self._indexed_key(target, data_root)
        if key in self._indexed_persisted:
            return
        self._indexed_persisted.add(key)
        self._pending_ops.append(
            ("put", DBColumn.SLASHER_INDEXED, key, indexed_bytes)
        )

    def _persist_blk(self, proposer: int, rec: _BlockRecord):
        if self._store is None:
            return
        from ..store.kv import DBColumn

        value = rec.header_root + rec.signed_header.serialize()
        self._pending_ops.append(
            ("put", DBColumn.SLASHER_BLOCK, self._blk_key(proposer, rec.slot), value)
        )

    def _load_from_store(self):
        from ..store.kv import DBColumn

        bodies: dict[bytes, object] = {}
        for key in self._store.keys(DBColumn.SLASHER_INDEXED):
            raw = self._store.get(DBColumn.SLASHER_INDEXED, key)
            bodies[key] = self._T.IndexedAttestation.deserialize(raw)
            self._indexed_persisted.add(key)
        for key in self._store.keys(DBColumn.SLASHER_ATTESTATION):
            vi = int.from_bytes(key[:8], "big")
            target = int.from_bytes(key[8:16], "big")
            raw = self._store.get(DBColumn.SLASHER_ATTESTATION, key)
            source = int.from_bytes(raw[:8], "little")
            data_root = raw[8:40]
            indexed = bodies.get(self._indexed_key(target, data_root))
            if indexed is None:
                continue  # body pruned/corrupt: drop the dangling record
            self._atts.setdefault(vi, {})[target] = _AttRecord(
                source, target, data_root, indexed
            )
        for key in self._store.keys(DBColumn.SLASHER_BLOCK):
            proposer = int.from_bytes(key[:8], "big")
            slot = int.from_bytes(key[8:16], "big")
            raw = self._store.get(DBColumn.SLASHER_BLOCK, key)
            header = self._T.SignedBeaconBlockHeader.deserialize(raw[32:])
            self._blocks.setdefault(proposer, {})[slot] = _BlockRecord(
                slot, raw[:32], header
            )

    def _flush_store(self):
        if self._store is None or not self._pending_ops:
            return
        ops, self._pending_ops = self._pending_ops, []
        self._store.do_atomically(ops)

    # -- batched processing (slasher.rs:125 process_queued) --------------------

    def process_queued(self, current_epoch: int) -> dict:
        inc_counter("slasher_process_cycles_total", engine="reference")
        found_att = 0
        found_blk = 0
        # atomic swap, not iterate-then-clear: cycles run on a worker
        # thread while gossip keeps feeding the queues
        att_queue, self._att_queue = self._att_queue, []
        block_queue, self._block_queue = self._block_queue, []
        inc_counter(
            "slasher_attestations_processed_total", amount=len(att_queue)
        )
        for indexed in att_queue:
            found_att += self._process_attestation(indexed)
        for header in block_queue:
            found_blk += self._process_block(header)
        self._prune(current_epoch)
        self._flush_store()
        if found_att:
            inc_counter("slasher_attester_slashings_found", amount=found_att)
        if found_blk:
            inc_counter("slasher_proposer_slashings_found", amount=found_blk)
        return {"attester_slashings": found_att, "proposer_slashings": found_blk}

    def _process_attestation(self, indexed) -> int:
        data = indexed.data
        s2, t2 = int(data.source.epoch), int(data.target.epoch)
        root2 = data.hash_tree_root()
        if self._store is not None and indexed.attesting_indices:
            # body stored once per attestation, not once per index
            self._persist_indexed(t2, root2, indexed.serialize())
        found = 0
        for vi in indexed.attesting_indices:
            vi = int(vi)
            records = self._atts.setdefault(vi, {})
            prev = records.get(t2)
            if prev is not None:
                if prev.data_root != root2:
                    key = (vi, t2, prev.data_root, root2)
                    if key not in self._emitted:
                        self._emitted.add(key)
                        self._emit_attester_slashing(prev.indexed, indexed)
                        found += 1
                continue  # same vote (or slashing emitted); nothing to record
            # surround checks against every recorded vote in the window.
            # attestation_1 must SURROUND attestation_2
            # (is_slashable_attestation_data: s1 < s2 and t2 < t1), so the
            # emit order depends on which vote is the surrounder.
            hit = None
            for rec in records.values():
                if rec.source < s2 and t2 < rec.target:
                    hit = (rec.indexed, indexed)  # old surrounds new
                    break
                if s2 < rec.source and rec.target < t2:
                    hit = (indexed, rec.indexed)  # new surrounds old
                    break
            if hit is not None:
                self._emit_attester_slashing(*hit)
                found += 1
            rec = _AttRecord(s2, t2, root2, indexed)
            records[t2] = rec
            self._persist_att(vi, rec)
        return found

    def _process_block(self, signed_header) -> int:
        h = signed_header.message
        proposer = int(h.proposer_index)
        slot = int(h.slot)
        root = h.hash_tree_root()
        blocks = self._blocks.setdefault(proposer, {})
        prev = blocks.get(slot)
        if prev is None:
            rec = _BlockRecord(slot, root, signed_header)
            blocks[slot] = rec
            self._persist_blk(proposer, rec)
            return 0
        if prev.header_root == root:
            return 0
        # a re-seen conflicting pair must not re-emit: every peer relays
        # both headers, so without this key the pool got one
        # ProposerSlashing per relay, not per equivocation
        key = (proposer, slot, prev.header_root, root)
        if key in self._emitted_blocks:
            return 0
        self._emitted_blocks.add(key)
        self._emit_proposer_slashing(prev.signed_header, signed_header)
        return 1

    # -- slashing construction -------------------------------------------------

    def _emit_attester_slashing(self, att1, att2):
        self.attester_slashings.append(
            self._T.AttesterSlashing(attestation_1=att1, attestation_2=att2)
        )

    def _emit_proposer_slashing(self, h1, h2):
        self.proposer_slashings.append(
            self._T.ProposerSlashing(signed_header_1=h1, signed_header_2=h2)
        )

    # -- pruning ---------------------------------------------------------------

    def _prune(self, current_epoch: int):
        from ..store.kv import DBColumn

        floor = max(0, current_epoch - self.config.history_length)
        self._emitted = {k for k in self._emitted if k[1] >= floor}
        slot_floor = floor * self.E.SLOTS_PER_EPOCH
        self._emitted_blocks = {
            k for k in self._emitted_blocks if k[1] >= slot_floor
        }
        if self._store is not None:
            # attestation bodies are epoch-prefixed: drop expired targets
            for key in [
                k
                for k in self._indexed_persisted
                if int.from_bytes(k[:8], "big") < floor
            ]:
                self._indexed_persisted.discard(key)
                self._pending_ops.append(
                    ("delete", DBColumn.SLASHER_INDEXED, key)
                )
        for vi in list(self._atts):
            recs = self._atts[vi]
            for t in [t for t in recs if t < floor]:
                del recs[t]
                if self._store is not None:
                    self._pending_ops.append(
                        ("delete", DBColumn.SLASHER_ATTESTATION, self._att_key(vi, t))
                    )
            if not recs:
                del self._atts[vi]
        for vi in list(self._blocks):
            blks = self._blocks[vi]
            for s in [s for s in blks if s < slot_floor]:
                del blks[s]
                if self._store is not None:
                    self._pending_ops.append(
                        ("delete", DBColumn.SLASHER_BLOCK, self._blk_key(vi, s))
                    )
            if not blks:
                del self._blocks[vi]

    # -- op-pool handoff (slasher/service feeds the pool) -----------------------

    def drain_slashings(self):
        atts, props = self.attester_slashings, self.proposer_slashings
        self.attester_slashings = []
        self.proposer_slashings = []
        return atts, props
