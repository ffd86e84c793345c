"""Columnar slashing-detection engine: array-program batch detection.

The tentpole rebuild of the scalar `reference.ReferenceSlasher`: a whole
`process_queued` cycle's attestations are detected with vectorized ops on
the validator axis instead of per-index dict probes —

  * per TARGET EPOCH, records live in sorted parallel numpy columns
    (validator / source / attestation-id / insertion-seq) with a
    per-cycle pending overlay (small dict, upgraded to dense arrays past
    a threshold) merged in one sorted insert per epoch per cycle;
  * double votes are a grouped ``(validator, target) -> attestation``
    comparison: one `searchsorted` gather per queue item against the
    epoch's validator column, root ids compared vectorized;
  * surround votes ride the chunked min/max-span arrays (`spans.py`):
    gather both spans at the item's source epoch, compare against the
    item's target distance in one vectorized predicate — both surround
    directions at once;
  * span updates are bulk ``np.minimum`` / ``np.maximum`` writebacks over
    the affected epoch window, grouped by (source, target) across the
    cycle so a mainnet epoch's 2048 attestations collapse into one
    update per distinct vote shape;
  * dirty span tiles, new records and attestation bodies persist through
    the KV columns in ONE atomic batch per cycle and reload on restart
    (a scalar-written DB is migrated by rebuilding spans from records).

EXACTNESS: the span filter is engineered to have no false negatives
(spans.py documents the guard set); every filter positive — and every
validator whose intra-cycle ordering matters (seen in 2+ queue items
this cycle) — is resolved by `_exact_scan`, a verbatim replay of the
scalar engine's insertion-ordered record walk. Detections are therefore
bit-identical to the reference engine, in the same emission order, which
the differential fuzz suite asserts. The stage pipeline runs under the
``slasher_process`` trace root with `span_gather` / `span_compare` /
`span_update` / `persist` child spans.
"""

from __future__ import annotations

import numpy as np

from ..metrics import inc_counter
from ..utils.tracing import span
from .reference import _BlockRecord, SlasherConfig
from .spans import DISTANCE_CAP, RECORDS_META_KEY, SpanStore

#: pending overlay upgrades from dict to dense arrays past this many
#: rows per epoch per cycle (a mainnet epoch pends ~1M rows; a test
#: cycle pends a handful)
_DENSE_THRESHOLD = 4096


class _EpochRecords:
    """All attestation records for one target epoch, columnar."""

    __slots__ = (
        "epoch",
        "base_v",
        "base_source",
        "base_att",
        "base_seq",
        "pending",
        "d_att",
        "d_source",
        "d_seq",
        "atts",
        "att_root",
        "att_root_np",
        "roots",
        "root_index",
    )

    def __init__(self, epoch: int):
        self.epoch = epoch
        self.base_v = np.zeros(0, dtype=np.int64)
        self.base_source = np.zeros(0, dtype=np.int64)
        self.base_att = np.zeros(0, dtype=np.int64)
        self.base_seq = np.zeros(0, dtype=np.int64)
        # per-cycle overlay: validator -> (source, att_id, seq)
        self.pending: dict[int, tuple[int, int, int]] = {}
        self.d_att = None  # dense overlay (validator-indexed), or None
        self.d_source = None
        self.d_seq = None
        # attestation table: att_id -> (data_root, IndexedAttestation) —
        # per-validator records point at the exact object that recorded
        # them (two aggregates may share a data root with different bits)
        self.atts: list[tuple[bytes, object]] = []
        self.att_root: list[int] = []  # att_id -> root_id
        self.att_root_np = np.zeros(0, dtype=np.int64)  # cycle-start snapshot
        self.roots: list[bytes] = []
        self.root_index: dict[bytes, int] = {}

    # -- roots / attestation table --------------------------------------------

    def root_id(self, root: bytes) -> int:
        rid = self.root_index.get(root)
        if rid is None:
            rid = len(self.roots)
            self.roots.append(root)
            self.root_index[root] = rid
        return rid

    def add_att(self, root: bytes, indexed) -> int:
        att_id = len(self.atts)
        self.atts.append((root, indexed))
        self.att_root.append(self.root_id(root))
        return att_id

    def refresh_att_root_np(self):
        if self.att_root_np.size != len(self.att_root):
            self.att_root_np = np.asarray(self.att_root, dtype=np.int64)

    # -- lookups ----------------------------------------------------------------

    def lookup_base_att(self, idx: np.ndarray) -> np.ndarray:
        """att_id per validator from the SORTED base columns (-1 absent).
        Base-only by design: the fast path masks out validators with any
        intra-cycle ordering dependency, so the pending overlay can never
        matter for it."""
        out = np.full(idx.shape, -1, dtype=np.int64)
        if self.base_v.size:
            pos = np.searchsorted(self.base_v, idx)
            pos_c = np.minimum(pos, self.base_v.size - 1)
            hit = self.base_v[pos_c] == idx
            out[hit] = self.base_att[pos_c[hit]]
        return out

    def get(self, v: int):
        """(source, att_id, seq) for one validator, overlay included."""
        if self.d_att is not None and v < self.d_att.size and self.d_att[v] >= 0:
            return (int(self.d_source[v]), int(self.d_att[v]), int(self.d_seq[v]))
        hit = self.pending.get(v)
        if hit is not None:
            return hit
        if self.base_v.size:
            pos = int(np.searchsorted(self.base_v, v))
            if pos < self.base_v.size and self.base_v[pos] == v:
                return (
                    int(self.base_source[pos]),
                    int(self.base_att[pos]),
                    int(self.base_seq[pos]),
                )
        return None

    # -- writes -----------------------------------------------------------------

    def _upgrade_dense(self, size_hint: int):
        n = max(size_hint, 1)
        self.d_att = np.full(n, -1, dtype=np.int64)
        self.d_source = np.zeros(n, dtype=np.int64)
        self.d_seq = np.zeros(n, dtype=np.int64)
        # entries past the dense size (hostile sparse ids) stay dict-held
        kept = {}
        for v, (src, att, seq) in self.pending.items():
            if v < n:
                self.d_att[v] = att
                self.d_source[v] = src
                self.d_seq[v] = seq
            else:
                kept[v] = (src, att, seq)
        self.pending = kept

    def _grow_dense(self, n: int):
        if n <= self.d_att.size:
            return
        for name, fill in (("d_att", -1), ("d_source", 0), ("d_seq", 0)):
            old = getattr(self, name)
            grown = np.full(n, fill, dtype=np.int64)
            grown[: old.size] = old
            setattr(self, name, grown)

    def put_rows(
        self, vals: np.ndarray, source: int, att_id: int, seq0: int, size_hint: int
    ):
        """Record `vals` (unique, no existing record) with consecutive
        seqs starting at seq0, in `vals` order."""
        self.put_rows_multi(
            vals,
            np.full(vals.size, att_id, dtype=np.int64),
            source,
            seq0,
            size_hint,
        )

    def put_rows_multi(
        self,
        vals: np.ndarray,
        att_rep: np.ndarray,
        source: int,
        seq0: int,
        size_hint: int,
    ):
        """One scatter for a whole shape group: `att_rep` carries each
        row's attestation-table id (np.repeat over the group's items).
        Validator ids past RESIDENT_ROWS_CAP (hostile sparse indices)
        stay in the dict overlay — the dense arrays never size to them."""
        from .spans import RESIDENT_ROWS_CAP

        if vals.size == 0:
            return
        if (
            self.d_att is None
            and len(self.pending) + vals.size > _DENSE_THRESHOLD
            and 0 < size_hint <= RESIDENT_ROWS_CAP
        ):
            self._upgrade_dense(size_hint)
        if self.d_att is not None:
            if int(vals.max()) >= RESIDENT_ROWS_CAP:
                # mixed hostile batch: the whole batch takes the dict
                # overlay (rare; the dense fast path is for honest floods)
                for i, (v, a) in enumerate(zip(vals.tolist(), att_rep.tolist())):
                    self.pending[v] = (source, int(a), seq0 + i)
                return
            self._grow_dense(int(vals.max()) + 1)
            self.d_att[vals] = att_rep
            self.d_source[vals] = source
            self.d_seq[vals] = np.arange(seq0, seq0 + vals.size, dtype=np.int64)
        else:
            for i, (v, a) in enumerate(zip(vals.tolist(), att_rep.tolist())):
                self.pending[v] = (source, int(a), seq0 + i)

    def merge(self):
        """Fold the cycle's overlay into the sorted base columns (one
        sorted insert per epoch per cycle). Dense and dict overlays may
        COEXIST (hostile sparse ids stay dict-held past the dense size);
        a validator appears in at most one of them."""
        parts = []
        if self.d_att is not None:
            vs = np.flatnonzero(self.d_att >= 0).astype(np.int64)
            if vs.size:
                parts.append(
                    (vs, self.d_source[vs], self.d_att[vs], self.d_seq[vs])
                )
            self.d_att = self.d_source = self.d_seq = None
        if self.pending:
            pv = np.array(sorted(self.pending), dtype=np.int64)
            rows = [self.pending[int(v)] for v in pv]
            parts.append(
                (
                    pv,
                    np.array([r[0] for r in rows], dtype=np.int64),
                    np.array([r[1] for r in rows], dtype=np.int64),
                    np.array([r[2] for r in rows], dtype=np.int64),
                )
            )
            self.pending.clear()
        if not parts:
            return
        if len(parts) == 1:
            vs, srcs, atts, seqs = parts[0]
        else:
            vs = np.concatenate([p[0] for p in parts])
            order = np.argsort(vs, kind="stable")
            vs = vs[order]
            srcs = np.concatenate([p[1] for p in parts])[order]
            atts = np.concatenate([p[2] for p in parts])[order]
            seqs = np.concatenate([p[3] for p in parts])[order]
        if not self.base_v.size:
            # first flood into a fresh epoch: the overlay IS the base
            # (flatnonzero/sort already yielded ascending validator ids)
            self.base_v, self.base_source = vs, srcs
            self.base_att, self.base_seq = atts, seqs
            return
        pos = np.searchsorted(self.base_v, vs)
        self.base_v = np.insert(self.base_v, pos, vs)
        self.base_source = np.insert(self.base_source, pos, srcs)
        self.base_att = np.insert(self.base_att, pos, atts)
        self.base_seq = np.insert(self.base_seq, pos, seqs)

    def __len__(self):
        dense = int((self.d_att >= 0).sum()) if self.d_att is not None else 0
        return self.base_v.size + len(self.pending) + dense


def _multiplicity_conflicts(all_v: np.ndarray) -> np.ndarray:
    """Validator indices appearing in 2+ queue positions this cycle.
    bincount when the index space is small enough to count densely (the
    production case), unique-with-counts for hostile sparse indices."""
    if not all_v.size:
        return np.zeros(0, dtype=np.int64)
    top = int(all_v.max())
    if top < 1 << 26:
        counts = np.bincount(all_v)
        return np.flatnonzero(counts > 1).astype(np.int64)
    uniq, counts = np.unique(all_v, return_counts=True)
    return uniq[counts > 1]


def _attestation_data_roots(datas: list) -> list[bytes]:
    """`hash_tree_root` of n AttestationData containers as THREE batched
    two-to-one hash passes (`utils/sha256_batch.hash_messages`) instead of
    n recursive SSZ walks — the per-item fixed cost that dominates a
    mainnet flood's decode. Byte-identical to `Container.hash_tree_root`
    (differential-tested): the 5 field roots merkleize at depth 3, and
    the right subtree H(H(target_root, Z0), Z1) depends only on the
    target checkpoint, so a flood's shared checkpoints hash once.
    """
    from ..utils.hash import ZERO_HASHES, hash32_concat
    from ..utils.sha256_batch import hash_messages

    n = len(datas)
    if n == 0:
        return []
    cp_cache: dict[tuple[int, bytes], bytes] = {}

    def cp_root(cp) -> bytes:
        key = (int(cp.epoch), bytes(cp.root))
        r = cp_cache.get(key)
        if r is None:
            r = hash32_concat(key[0].to_bytes(8, "little") + b"\x00" * 24, key[1])
            cp_cache[key] = r
        return r

    right_cache: dict[bytes, bytes] = {}

    def right_subtree(tgt_root: bytes) -> bytes:
        r = right_cache.get(tgt_root)
        if r is None:
            r = hash32_concat(
                hash32_concat(tgt_root, ZERO_HASHES[0]), ZERO_HASHES[1]
            )
            right_cache[tgt_root] = r
        return r

    # level 0: a = H(pack(slot) || pack(index)), b = H(bbr || source_root)
    rows0 = bytearray(2 * n * 64)
    tgt_roots = []
    for i, d in enumerate(datas):
        o = i * 128
        rows0[o : o + 8] = int(d.slot).to_bytes(8, "little")
        rows0[o + 32 : o + 40] = int(d.index).to_bytes(8, "little")
        rows0[o + 64 : o + 96] = bytes(d.beacon_block_root)
        rows0[o + 96 : o + 128] = cp_root(d.source)
        tgt_roots.append(cp_root(d.target))
    ab = hash_messages(
        np.frombuffer(bytes(rows0), dtype=np.uint8).reshape(2 * n, 64)
    )
    # level 1 left: e = H(a || b); level 2: root = H(e || right(target))
    e = hash_messages(ab.reshape(n, 64))
    rows2 = np.empty((n, 64), dtype=np.uint8)
    rows2[:, :32] = e
    for i, tr in enumerate(tgt_roots):
        rows2[i, 32:] = np.frombuffer(right_subtree(tr), dtype=np.uint8)
    roots = hash_messages(rows2)
    return [roots[i].tobytes() for i in range(n)]


class _Item:
    """One queued IndexedAttestation, decoded for the array pipeline."""

    __slots__ = ("indexed", "source", "target", "root", "idx", "att_id")

    def __init__(self, indexed, root: bytes):
        data = indexed.data
        self.indexed = indexed
        self.source = int(data.source.epoch)
        self.target = int(data.target.epoch)
        self.root = root  # batch-hashed by _attestation_data_roots
        # ORIGINAL wire order: the oracle iterates attesting_indices as
        # given, and emission order must match it position-for-position
        try:
            self.idx = np.asarray(indexed.attesting_indices, dtype=np.int64)
        except (TypeError, ValueError):
            self.idx = np.asarray(
                [int(v) for v in indexed.attesting_indices], dtype=np.int64
            )
        if self.idx.ndim != 1:
            self.idx = self.idx.reshape(-1)
        self.att_id = None  # this item's entry in its epoch's att table


class ColumnarSlasher:
    """Array-program slasher over chunked min/max spans.

    Public surface and emission semantics are identical to
    `reference.ReferenceSlasher`; `tests/test_slasher_columnar.py` fuzzes
    the equivalence (streams, prune-mid-stream, restart-resume)."""

    def __init__(self, E, config: SlasherConfig | None = None, store=None):
        from ..types.containers import build_types

        self.E = E
        self.config = config or SlasherConfig()
        self._T = build_types(E)
        #: target epoch -> columnar record store
        self._epochs: dict[int, _EpochRecords] = {}
        self._blocks: dict[int, dict[int, _BlockRecord]] = {}
        self._att_queue: list = []
        self._block_queue: list = []
        self.attester_slashings: list = []
        self.proposer_slashings: list = []
        self._emitted: set = set()
        self._emitted_blocks: set = set()
        self._store = store
        self._pending_ops: list = []
        self._indexed_persisted: set[bytes] = set()
        #: global insertion sequence — per-validator record scan order
        #: (the scalar dict's insertion order, reproduced exactly)
        self._seq = 0
        self._floor = 0
        # live record-set fingerprint (engine-interlude staleness check)
        self._fp_count = 0
        self._fp_acc = np.uint64(0)
        self.spans = SpanStore(kv=store, history_length=self.config.history_length)
        if store is not None:
            self._load_from_store()

    # -- ingestion --------------------------------------------------------------

    def accept_attestation(self, indexed_attestation):
        self._att_queue.append(indexed_attestation)

    def accept_block_header(self, signed_header):
        self._block_queue.append(signed_header)

    # -- introspection (engine-generic test surface) -----------------------------

    def has_attestation_record(self, vi: int, target: int) -> bool:
        es = self._epochs.get(int(target))
        return es is not None and es.get(int(vi)) is not None

    def attestation_record_count(self) -> int:
        return sum(len(es) for es in self._epochs.values())

    # -- persistence -------------------------------------------------------------

    _att_key = staticmethod(
        lambda vi, target: vi.to_bytes(8, "big") + target.to_bytes(8, "big")
    )
    _blk_key = staticmethod(
        lambda proposer, slot: proposer.to_bytes(8, "big") + slot.to_bytes(8, "big")
    )
    _indexed_key = staticmethod(
        lambda target, data_root: target.to_bytes(8, "big") + data_root
    )

    def _persist_indexed(self, target: int, data_root: bytes, indexed):
        if self._store is None:
            return
        from ..store.kv import DBColumn

        key = self._indexed_key(target, data_root)
        if key in self._indexed_persisted:
            return
        self._indexed_persisted.add(key)
        self._pending_ops.append(
            ("put", DBColumn.SLASHER_INDEXED, key, indexed.serialize())
        )

    def _persist_records(self, target: int, vals: np.ndarray, source: int, root: bytes):
        """Per-record rows, same key/value shape as the scalar engine (a
        DB is portable between engines in both directions)."""
        if self._store is None:
            return
        from ..store.kv import DBColumn

        value = source.to_bytes(8, "little") + root
        t_be = target.to_bytes(8, "big")
        self._pending_ops.extend(
            ("put", DBColumn.SLASHER_ATTESTATION, int(v).to_bytes(8, "big") + t_be, value)
            for v in vals.tolist()
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
        """Reload records/blocks in store order (the scalar engine's exact
        reload semantics, including the dangling-record drop), then adopt
        the persisted span tiles — or, for a DB written by the scalar
        engine, rebuild the spans from the reloaded records."""
        from ..store.kv import DBColumn

        bodies: dict[bytes, object] = {}
        for key in self._store.keys(DBColumn.SLASHER_INDEXED):
            raw = self._store.get(DBColumn.SLASHER_INDEXED, key)
            bodies[key] = self._T.IndexedAttestation.deserialize(raw)
            self._indexed_persisted.add(key)
        # (target, root) -> att_id memo so each reloaded body gets one
        # attestation-table entry per epoch store
        att_ids: dict[tuple[int, bytes], int] = {}
        rows_by_epoch: dict[int, list[tuple[int, int, int, int]]] = {}
        for key in self._store.keys(DBColumn.SLASHER_ATTESTATION):
            vi = int.from_bytes(key[:8], "big")
            target = int.from_bytes(key[8:16], "big")
            raw = self._store.get(DBColumn.SLASHER_ATTESTATION, key)
            source = int.from_bytes(raw[:8], "little")
            data_root = raw[8:40]
            indexed = bodies.get(self._indexed_key(target, data_root))
            if indexed is None:
                continue  # body pruned/corrupt: drop the dangling record
            es = self._epochs.get(target)
            if es is None:
                es = self._epochs[target] = _EpochRecords(target)
            att_id = att_ids.get((target, data_root))
            if att_id is None:
                att_id = att_ids[(target, data_root)] = es.add_att(data_root, indexed)
            rows_by_epoch.setdefault(target, []).append(
                (vi, source, att_id, self._seq)
            )
            self._seq += 1
        for target, rows in rows_by_epoch.items():
            es = self._epochs[target]
            vs = np.array([r[0] for r in rows], dtype=np.int64)
            order = np.argsort(vs, kind="stable")
            es.base_v = vs[order]
            es.base_source = np.array([r[1] for r in rows], dtype=np.int64)[order]
            es.base_att = np.array([r[2] for r in rows], dtype=np.int64)[order]
            es.base_seq = np.array([r[3] for r in rows], dtype=np.int64)[order]
            self._fp_update(es.base_v, target)
        for key in self._store.keys(DBColumn.SLASHER_BLOCK):
            proposer = int.from_bytes(key[:8], "big")
            slot = int.from_bytes(key[8:16], "big")
            raw = self._store.get(DBColumn.SLASHER_BLOCK, key)
            header = self._T.SignedBeaconBlockHeader.deserialize(raw[32:])
            self._blocks.setdefault(proposer, {})[slot] = _BlockRecord(
                slot, raw[:32], header
            )
        self._floor = self.spans.floor
        # coarse source columns rebuild from the reloaded records
        for es in self._epochs.values():
            self.spans.seed_sources(es.base_v, es.base_source)
        # trust the persisted tiles ONLY if the record-set fingerprint
        # stored with them matches the rows just reloaded: a mismatch
        # (scalar-engine interlude via the kill switch, pre-fingerprint
        # DB) means records exist whose span contribution was never
        # written — rebuild, or surrounds would be silently missed
        if self._epochs and (
            not self.spans.has_tiles
            or self.spans.read_records_meta() != self._records_fingerprint()
        ):
            self._rebuild_spans()

    def _rebuild_spans(self):
        """Scalar-engine DB migration: replay every reloaded record into
        the span arrays, grouped by (source, target)."""
        inc_counter("slasher_span_rebuilds_total")
        groups: dict[tuple[int, int], list[np.ndarray]] = {}
        current = 0
        for target, es in self._epochs.items():
            current = max(current, target)
            if not es.base_v.size:
                continue
            for source in np.unique(es.base_source).tolist():
                groups.setdefault((int(source), target), []).append(
                    es.base_v[es.base_source == source]
                )
        for (source, target), parts in groups.items():
            self.spans.record(
                np.concatenate(parts), source, target, current_epoch=current
            )

    @staticmethod
    def _fp_mix(vals: np.ndarray, target: int) -> np.uint64:
        return np.bitwise_xor.reduce(
            vals.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
            ^ np.uint64((target * 0xC2B2AE3D27D4EB4F) & 0xFFFFFFFFFFFFFFFF)
        )

    def _fp_update(self, vals: np.ndarray, target: int, removed: bool = False):
        """Fold record rows into the live-set fingerprint. XOR is its own
        inverse, so insert and delete use the same mix — the fingerprint
        stays O(changed rows) per cycle, never a full rescan."""
        if vals.size:
            self._fp_acc = self._fp_acc ^ self._fp_mix(vals, target)
            self._fp_count += -int(vals.size) if removed else int(vals.size)

    def _records_fingerprint(self) -> bytes:
        """Order-independent fingerprint of the live record rows
        (count + XOR of per-row mixes): persisted with the span tiles so
        a reload can tell whether they reflect this exact record set."""
        return self._fp_count.to_bytes(8, "big") + int(self._fp_acc).to_bytes(
            8, "big"
        )

    def _flush_store(self):
        ops = self._pending_ops
        self._pending_ops = []
        span_ops = self.spans.flush_ops()
        if span_ops:
            inc_counter(
                "slasher_span_tiles_flushed_total",
                amount=sum(1 for op in span_ops if op[0] == "put" and len(op[2]) == 16),
            )
        ops.extend(span_ops)
        if self._store is None or not ops:
            return
        from ..store.kv import DBColumn

        # fingerprint rides every batch that changed anything: the
        # reload-time staleness check depends on it being current
        ops.append(
            (
                "put",
                DBColumn.SLASHER_MIN_SPAN,
                RECORDS_META_KEY,
                self._records_fingerprint(),
            )
        )
        self._store.do_atomically(ops)

    # -- batched processing ------------------------------------------------------

    def process_queued(self, current_epoch: int) -> dict:
        with span("slasher_process", epoch=int(current_epoch)):
            inc_counter("slasher_process_cycles_total", engine="columnar")
            # atomic swap, not iterate-then-clear: gossip threads keep
            # appending while a multi-hundred-ms cycle runs on a worker,
            # and those arrivals must survive into the next cycle
            att_queue, self._att_queue = self._att_queue, []
            block_queue, self._block_queue = self._block_queue, []
            inc_counter(
                "slasher_attestations_processed_total", amount=len(att_queue)
            )
            found_att = self._process_attestation_queue(att_queue, current_epoch)
            found_blk = 0
            for header in block_queue:
                found_blk += self._process_block(header)
            self._prune(current_epoch)
            with span("persist"):
                self._flush_store()
            if found_att:
                inc_counter("slasher_attester_slashings_found", amount=found_att)
            if found_blk:
                inc_counter("slasher_proposer_slashings_found", amount=found_blk)
            return {
                "attester_slashings": found_att,
                "proposer_slashings": found_blk,
            }

    def _process_attestation_queue(self, att_queue: list, current_epoch: int) -> int:
        if not att_queue:
            return 0
        roots = _attestation_data_roots([ix.data for ix in att_queue])
        items = [_Item(ix, r) for ix, r in zip(att_queue, roots)]
        # Validators seen in 2+ queue positions this cycle (equivocators,
        # duplicate aggregates, hostile repeats) have intra-cycle ordering
        # dependencies: they take the sequential exact path. Everyone else
        # (the whole honest flood) is order-free — per-validator state is
        # touched by exactly one item — and runs stage-major, vectorized
        # per (source, target) SHAPE GROUP: a mainnet epoch's 2048
        # attestations share one (source, target), so the whole flood is
        # ONE set of array ops.
        all_v = np.concatenate([it.idx for it in items if it.idx.size] or
                               [np.zeros(0, dtype=np.int64)])
        conflicted_arr = _multiplicity_conflicts(all_v)
        has_conflicts = conflicted_arr.size > 0
        # dense boolean membership for the conflicted set: one O(n)
        # gather per use instead of a 1M-row sort per np.isin — None
        # when hostile sparse indices make a dense table unreasonable
        conflicted_lut = None
        # guard on all_v (the table's SIZE), not conflicted_arr: one
        # hostile sparse index in any item would otherwise size the
        # table to it even when the duplicated indices are small
        if has_conflicts and int(all_v.max()) < 1 << 26:
            conflicted_lut = np.zeros(int(all_v.max()) + 1, dtype=bool)
            conflicted_lut[conflicted_arr] = True

        for it in items:
            # body stored once per attestation, not once per index (the
            # scalar engine's exact persistence behavior)
            if self._store is not None and it.idx.size:
                self._persist_indexed(it.target, it.root, it.indexed)

        # shape groups in queue order of first appearance; each entry
        # keeps its GLOBAL queue index for emission ordering
        groups: dict[tuple[int, int], list[tuple[int, _Item]]] = {}
        for item_i, it in enumerate(items):
            if it.idx.size:
                groups.setdefault((it.source, it.target), []).append((item_i, it))

        # emissions tagged (item_i, position) so fast- and slow-path
        # findings merge back into the oracle's exact append order
        emissions: list[tuple[int, int, object, object]] = []
        size_hint = int(all_v.max()) + 1 if all_v.size else 0

        for (source, target), members in groups.items():
            self._process_shape_group(
                source,
                target,
                members,
                conflicted_arr,
                conflicted_lut,
                current_epoch,
                size_hint,
                emissions,
            )

        if has_conflicts:
            self._process_conflicted(
                items, conflicted_arr, conflicted_lut, current_epoch, emissions
            )
        emissions.sort(key=lambda e: (e[0], e[1]))
        for _i, _p, att1, att2 in emissions:
            self._emit_attester_slashing(att1, att2)
        self._merge_epochs()
        return len(emissions)

    def _process_shape_group(
        self,
        source: int,
        target: int,
        members: list,
        conflicted_arr: np.ndarray,
        conflicted_lut,
        current_epoch: int,
        size_hint: int,
        emissions: list,
    ):
        """All of one cycle's items sharing (source, target): gather,
        compare and record the concatenated index arrays in one set of
        vectorized ops."""
        es = self._epochs.get(target)
        lens = np.array([it.idx.size for _i, it in members], dtype=np.int64)
        offsets = np.concatenate(([0], np.cumsum(lens)))
        concat = (
            members[0][1].idx
            if len(members) == 1
            else np.concatenate([it.idx for _i, it in members])
        )

        def item_pos(gpos: int) -> tuple[int, int]:
            k = int(np.searchsorted(offsets, gpos, side="right")) - 1
            return k, gpos - int(offsets[k])

        with span("span_gather"):
            if es is not None:
                es.refresh_att_root_np()
                prev_att = es.lookup_base_att(concat)
            else:
                prev_att = np.full(concat.shape, -1, dtype=np.int64)
            d = target - source
            scan_all = d < 0 or source < self._floor or d >= DISTANCE_CAP
            if not scan_all:
                mins = self.spans.gather_min(concat, source)
                maxs = self.spans.gather_max(concat, source)
                guard = self.spans.scan_guard_mask(concat, source)

        with span("span_compare"):
            if conflicted_lut is not None:
                fast = ~conflicted_lut[concat]
            elif conflicted_arr.size:
                fast = ~np.isin(concat, conflicted_arr)
            else:
                fast = np.ones(concat.shape, dtype=bool)
            exists = prev_att >= 0
            # double votes: previously recorded attestation with a
            # different data root at the same target
            if es is not None and exists.any():
                rid_per_item = np.array(
                    [es.root_index.get(it.root, -1) for _i, it in members],
                    dtype=np.int64,
                )
                rep_rid = np.repeat(rid_per_item, lens)
                dbl = fast & exists
                dbl[dbl] = es.att_root_np[prev_att[dbl]] != rep_rid[dbl]
                for gpos in np.flatnonzero(dbl).tolist():
                    k, pos = item_pos(gpos)
                    item_i, it = members[k]
                    vi = int(concat[gpos])
                    prev_root, prev_indexed = es.atts[int(prev_att[gpos])]
                    key = (vi, target, prev_root, it.root)
                    if key not in self._emitted:
                        self._emitted.add(key)
                        emissions.append((item_i, pos, prev_indexed, it.indexed))
            # surround candidates among the to-be-recorded validators:
            # both directions in one vectorized predicate over the spans
            new_mask = fast & ~exists
            if scan_all:
                cand = new_mask
            elif new_mask.any():
                du16 = np.uint16(d)
                cand = new_mask & ((mins < du16) | (maxs > du16) | guard)
            else:
                cand = new_mask
            for gpos in np.flatnonzero(cand).tolist():
                hit = self._exact_scan(int(concat[gpos]), source, target)
                if hit is not None:
                    k, pos = item_pos(gpos)
                    item_i, it = members[k]
                    first, second = hit
                    emissions.append(
                        (
                            item_i,
                            pos,
                            first if first is not None else it.indexed,
                            second if second is not None else it.indexed,
                        )
                    )

        with span("span_update"):
            if not new_mask.any():
                return
            # per-item new-row counts, vectorized; one attestation-table
            # entry per recording item, one dense scatter for the group
            cs = np.concatenate(([0], np.cumsum(new_mask)))
            new_lens = cs[offsets[1:]] - cs[offsets[:-1]]
            vals = concat[new_mask]
            if es is None:
                es = self._epochs[target] = _EpochRecords(target)
            att_ids = []
            for k, ((_item_i, it), nl) in enumerate(zip(members, new_lens.tolist())):
                if nl:
                    att_ids.append((self._att_id_for(es, it), nl))
                    if self._store is not None:
                        sl = new_mask[offsets[k] : offsets[k + 1]]
                        self._persist_records(target, it.idx[sl], source, it.root)
            att_rep = np.repeat(
                np.array([a for a, _n in att_ids], dtype=np.int64),
                np.array([n for _a, n in att_ids], dtype=np.int64),
            )
            es.put_rows_multi(vals, att_rep, source, self._seq, size_hint)
            self._seq += vals.size
            self._fp_update(vals, target)
            self.spans.record(vals, source, target, current_epoch)

    @staticmethod
    def _att_id_for(es: _EpochRecords, it: _Item) -> int:
        """One att-table entry per (item, epoch store): fast and slow
        paths recording rows for the same queue item share it."""
        if it.att_id is None:
            it.att_id = es.add_att(it.root, it.indexed)
        return it.att_id

    def _process_conflicted(
        self, items, conflicted_arr, conflicted_lut, current_epoch: int, emissions: list
    ):
        """Sequential exact path for validators with intra-cycle ordering
        dependencies — a verbatim replay of the scalar per-index loop, in
        queue order, against the columnar stores. Each item's conflicted
        POSITIONS are found vectorized first: a couple of equivocators
        must not cost a Python walk over the whole honest flood."""
        for item_i, it in enumerate(items):
            if not it.idx.size:
                continue
            if conflicted_lut is not None:
                hits = np.flatnonzero(conflicted_lut[it.idx])
            else:
                hits = np.flatnonzero(np.isin(it.idx, conflicted_arr))
            if not hits.size:
                continue
            es = None
            for pos in hits.tolist():
                vi = int(it.idx[pos])
                if es is None:
                    es = self._epochs.get(it.target)
                    if es is None:
                        es = self._epochs[it.target] = _EpochRecords(it.target)
                prev = es.get(vi)
                if prev is not None:
                    prev_root, prev_indexed = es.atts[prev[1]]
                    if prev_root != it.root:
                        key = (vi, it.target, prev_root, it.root)
                        if key not in self._emitted:
                            self._emitted.add(key)
                            emissions.append((item_i, pos, prev_indexed, it.indexed))
                    continue  # same vote: nothing to record
                hit = self._exact_scan(vi, it.source, it.target)
                if hit is not None:
                    first, second = hit
                    emissions.append(
                        (
                            item_i,
                            pos,
                            first if first is not None else it.indexed,
                            second if second is not None else it.indexed,
                        )
                    )
                one = np.array([vi], dtype=np.int64)
                es.put_rows(one, it.source, self._att_id_for(es, it), self._seq, 0)
                self._seq += 1
                self._fp_update(one, it.target)
                self._persist_records(it.target, one, it.source, it.root)
                self.spans.record(one, it.source, it.target, current_epoch)

    def _exact_scan(self, vi: int, s2: int, t2: int):
        """The oracle's surround walk: this validator's records in
        insertion-seq order, first hit wins, direction priority as in
        `is_slashable_attestation_data`. Returns (att1, att2) with None
        standing for "the new attestation", or None for no hit."""
        inc_counter("slasher_exact_scans_total")
        recs = []
        for target, es in self._epochs.items():
            row = es.get(vi)
            if row is not None:
                recs.append((row[2], row[0], target, row[1], es))
        recs.sort()
        for _seq, source, target, att_id, es in recs:
            if source < s2 and t2 < target:
                return (es.atts[att_id][1], None)  # old surrounds new
            if s2 < source and target < t2:
                return (None, es.atts[att_id][1])  # new surrounds old
        return None

    def _merge_epochs(self):
        for es in self._epochs.values():
            es.merge()

    # -- blocks (double proposals; low-volume, dict bookkeeping) -----------------

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
        # re-seen conflicting pair: one emission per equivocation, not
        # one per relay (dedup keyed like the attestation path)
        key = (proposer, slot, prev.header_root, root)
        if key in self._emitted_blocks:
            return 0
        self._emitted_blocks.add(key)
        self._emit_proposer_slashing(prev.signed_header, signed_header)
        return 1

    # -- slashing construction ---------------------------------------------------

    def _emit_attester_slashing(self, att1, att2):
        self.attester_slashings.append(
            self._T.AttesterSlashing(attestation_1=att1, attestation_2=att2)
        )

    def _emit_proposer_slashing(self, h1, h2):
        self.proposer_slashings.append(
            self._T.ProposerSlashing(signed_header_1=h1, signed_header_2=h2)
        )

    # -- pruning -----------------------------------------------------------------

    def _prune(self, current_epoch: int):
        # every cycle, like the oracle — no early-out: block records and
        # dedup keys can expire even when no attestation epoch did, and
        # skipping them would diverge from the reference's emissions
        from ..store.kv import DBColumn

        floor = max(0, current_epoch - self.config.history_length)
        self._floor = max(self._floor, floor)
        self._emitted = {k for k in self._emitted if k[1] >= floor}
        slot_floor = floor * self.E.SLOTS_PER_EPOCH
        self._emitted_blocks = {
            k for k in self._emitted_blocks if k[1] >= slot_floor
        }
        if self._store is not None:
            for key in [
                k
                for k in self._indexed_persisted
                if int.from_bytes(k[:8], "big") < floor
            ]:
                self._indexed_persisted.discard(key)
                self._pending_ops.append(("delete", DBColumn.SLASHER_INDEXED, key))
        for target in [t for t in self._epochs if t < floor]:
            es = self._epochs.pop(target)
            self._fp_update(es.base_v, target, removed=True)
            if self._store is not None:
                t_be = target.to_bytes(8, "big")
                self._pending_ops.extend(
                    ("delete", DBColumn.SLASHER_ATTESTATION, int(v).to_bytes(8, "big") + t_be)
                    for v in es.base_v.tolist()
                )
        self._pending_ops.extend(self.spans.prune(floor))
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

    # -- op-pool handoff ----------------------------------------------------------

    def drain_slashings(self):
        atts, props = self.attester_slashings, self.proposer_slashings
        self.attester_slashings = []
        self.proposer_slashings = []
        return atts, props
