"""Background finality migration + cold-state restore points.

The beacon_chain/src/migrate.rs analog: every time the finalized
checkpoint advances, finalized canonical blocks move hot→cold (the
split advances with them), abandoned forks are dropped, hot states
strictly before the split are pruned, and the DA availability window is
trimmed — all in one migration cycle. On top of the reference's block
migration this module owns the cold-state story
(store/src/reconstruct.rs): every `slots_per_restore_point` slots the
about-to-be-pruned canonical state is written to the COLD db as a
restore point, and `reconstruct_state` rebuilds any intermediate
pre-split state by replaying blocks forward from the nearest restore
point (bounded LRU on the results).

The cycle rides its OWN beacon_processor lane when a processor is wired
(`WorkType.MIGRATE_STORE`, dead last — nothing protocol-critical waits
on store hygiene): the block-import tail claims the finalized epoch
atomically and submits the cycle instead of running it inline, exactly
the SLASHER_PROCESS / STATE_ADVANCE pattern. Without a processor the
cycle runs inline under the already-held import lock (tests,
timer-only nodes). Epoch claims are atomic so the import path and any
slot tick can both fire without double-migrating an epoch.

Each cycle also re-points the store's anchor watermark at the new
finalized checkpoint and persists a compact fork-choice snapshot, which
is what lets `BeaconChain.from_store` restart a node from its KV store.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict

from ..metrics import REGISTRY, inc_counter, set_gauge
from .kv import DBColumn
from ..utils.logging import get_logger
from ..utils.safe_arith import saturating_sub
from ..utils.tracing import span

log = get_logger("store.migrator")

# Eager registration: the conftest metric guard asserts these exist at
# zero, and the churn-soak oracle differences them across phases.
REGISTRY.counter(
    "store_migrations_total",
    "finality migration cycles completed (hot→cold batch + prune)",
).inc(0)
REGISTRY.counter(
    "store_blocks_migrated_total",
    "finalized canonical blocks moved hot→cold",
).inc(0)
REGISTRY.counter(
    "store_cold_snapshots_total",
    "restore-point states written to the cold DB",
).inc(0)
REGISTRY.counter(
    "store_states_reconstructed_total",
    "pre-split states rebuilt by restore-point replay",
).inc(0)
REGISTRY.counter(
    "store_da_entries_pruned_total",
    "blob/column sidecar sets dropped by availability-window pruning",
).inc(0)
set_gauge("store_split_slot", 0)
REGISTRY.histogram(
    "trace_span_seconds_store_prune",
    "span duration: one finality migration cycle",
)
REGISTRY.histogram(
    "trace_span_seconds_store_reconstruct",
    "span duration: one restore-point state reconstruction",
)


class BackgroundMigrator:
    """Finality-driven store migration with an atomic per-epoch claim.

    `chain.migrator` is attached at construction; the chain's import
    tail calls `on_finality()` (inline fallback under the import lock),
    and the client wires `processor` so cycles ride the
    MIGRATE_STORE lane instead.
    """

    def __init__(
        self,
        chain,
        slots_per_restore_point: int | None = None,
        reconstruction_cache_size: int = 8,
    ):
        self.chain = chain
        self.store = chain.store
        # restore-point spacing: smaller = cheaper reconstruction replay,
        # larger = smaller cold DB (BENCH_NOTES.md "Storage lifecycle")
        self.slots_per_restore_point = int(
            slots_per_restore_point
            if slots_per_restore_point is not None
            else 2 * chain.E.SLOTS_PER_EPOCH
        )
        if self.slots_per_restore_point <= 0:
            raise ValueError("slots_per_restore_point must be positive")
        self.processor = None  # wired by the client; None = inline
        # A/B seam: the store_soak bench and the differential
        # reconstruction test run a never-pruned chain by flipping this
        self.enabled = True
        self._epoch_lock = threading.Lock()
        self._last_migrated_epoch = 0
        # cycles must never overlap: the walk mutates chain maps and the
        # split; the queued path and the inline fallback can otherwise
        # race each other across consecutive finality advances
        self._run_lock = threading.Lock()
        self._recon_lock = threading.Lock()
        self._recon_cache: OrderedDict[bytes, object] = OrderedDict()
        self._recon_cache_size = int(reconstruction_cache_size)
        chain.migrator = self

    # -- epoch claim (slasher/service.py pattern) -------------------------

    def _claim_epoch(self, epoch: int) -> bool:
        with self._epoch_lock:
            if epoch <= self._last_migrated_epoch:
                return False
            self._last_migrated_epoch = epoch
            return True

    def _unclaim_epoch(self, epoch: int):
        with self._epoch_lock:
            if self._last_migrated_epoch == epoch:
                self._last_migrated_epoch = epoch - 1

    # -- entry points ------------------------------------------------------

    def on_finality(self, processor=None):
        """Called from the block-import tail (import lock HELD) whenever
        a block lands; no-ops unless the finalized epoch advanced. With a
        processor the cycle is submitted on the MIGRATE_STORE lane and
        runs once the import lock frees; a refused submit (backpressure /
        shutdown race) unclaims so the next finality advance retries.
        Without one the cycle runs inline under the caller's lock."""
        if not self.enabled:
            return None
        fin = self.chain.finalized_checkpoint
        epoch = int(fin.epoch)
        if epoch == 0 or not self._claim_epoch(epoch):
            return None
        processor = processor if processor is not None else self.processor
        if processor is not None:
            from ..beacon_processor import WorkType

            if not processor.submit(
                WorkType.MIGRATE_STORE, epoch, self._migrate_queued
            ):
                self._unclaim_epoch(epoch)
            return None
        with self._run_lock:
            return self._migrate_cycle()

    def _migrate_queued(self, _epoch: int):
        """Worker-thread entry: the import write lock serializes the
        cycle against concurrent block imports."""
        with self.chain.import_lock.acquire_write():
            with self._run_lock:
                return self._migrate_cycle()

    # -- the migration cycle ----------------------------------------------

    def _migrate_cycle(self):
        """One finality migration batch (import lock held by the caller).

        Reads the finalized checkpoint at RUN time (a queued cycle may
        observe a newer finality than the one that claimed it — migrating
        to the newest boundary is strictly more work done, never less).
        """
        from ..state_processing.accessors import compute_start_slot_at_epoch

        chain = self.chain
        store = self.store
        finalized = chain.finalized_checkpoint
        if finalized.epoch == 0:
            return None
        with span("store_prune"):
            finalized_slot = compute_start_slot_at_epoch(
                finalized.epoch, chain.E
            )
            chain.data_availability_checker.prune_before(finalized_slot)
            chain.block_times_cache.prune(finalized_slot)
            droppable = [
                root
                for root, st in chain._states.items()
                if st.slot < finalized_slot
                and root != chain.head_root
                and root != finalized.root
            ]
            # canonical finalized ancestors, walked via block parent links
            # (the proto array may already have pruned these nodes)
            canonical: set[bytes] = set()
            r = finalized.root
            while True:
                blk = chain._blocks_by_root.get(r)
                if blk is None:
                    break
                parent = blk.message.parent_root
                if parent in canonical or parent == r:
                    break
                canonical.add(parent)
                r = parent

            migrated = []
            snapshots = 0
            for root in droppable:
                st = chain._states.pop(root, None)
                in_canon = root in canonical
                if st is not None:
                    # the block already carries the state root — no re-hash
                    blk = chain._blocks_by_root.get(root)
                    state_root = (
                        blk.message.state_root
                        if blk is not None
                        else st.hash_tree_root()
                    )
                    if in_canon and self._is_restore_point(st.slot):
                        # restore point: the cold copy is what replay
                        # anchors on; only the hot copy is deleted
                        store.put_cold_state(state_root, st)
                        store.delete_state(state_root, side="hot")
                        snapshots += 1
                    else:
                        store.delete_state(state_root)
                if in_canon:
                    migrated.append(root)
                else:
                    # pruned fork: drop entirely (incl. staged sidecars)
                    chain._blocks_by_root.pop(root, None)
                    store.delete_blob_sidecars(root)
                    store.delete_data_column_sidecars(root)
            if migrated:
                store.migrate_to_cold(finalized_slot, migrated)
                inc_counter("store_blocks_migrated_total", len(migrated))
            if snapshots:
                inc_counter("store_cold_snapshots_total", snapshots)

            # DA retention: drop sidecars/columns of canonical blocks aged
            # out of the window; orphan backstop for staged losers whose
            # block never imported
            da_pruned = 0
            da_cutoff = saturating_sub(finalized_slot, chain.da_window_slots())
            for root, _sc_slot in store.blob_sidecar_entries_before(da_cutoff):
                store.delete_blob_sidecars(root)
                da_pruned += 1
            for root, _sc_slot in store.data_column_entries_before(da_cutoff):
                store.delete_data_column_sidecars(root)
                da_pruned += 1
            for root, _sc_slot in store.blob_sidecar_entries():
                if root not in chain._blocks_by_root and not store.block_exists(
                    root
                ):
                    store.delete_blob_sidecars(root)
                    da_pruned += 1
            for root, _sc_slot in store.data_column_entries():
                if root not in chain._blocks_by_root and not store.block_exists(
                    root
                ):
                    store.delete_data_column_sidecars(root)
                    da_pruned += 1
            if da_pruned:
                inc_counter("store_da_entries_pruned_total", da_pruned)
            chain.observed_attesters.prune(finalized.epoch)
            chain.observed_aggregators.prune(finalized.epoch)
            chain.observed_block_producers.prune(finalized_slot)  # by slot

            self._persist_resume_point(finalized)
            store.bump_generation()
            inc_counter("store_migrations_total")
            set_gauge("store_split_slot", store.split_slot)
        return len(migrated)

    def _is_restore_point(self, slot: int) -> bool:
        return int(slot) % self.slots_per_restore_point == 0

    def _persist_resume_point(self, finalized):
        """Re-point the anchor watermark at the newest finalized
        checkpoint and persist a compact fork-choice snapshot — the two
        meta records `BeaconChain.from_store` restarts from."""
        chain = self.chain
        blk = chain._blocks_by_root.get(finalized.root)
        if blk is None:
            blk = chain.store.get_block(finalized.root)
        if blk is None:
            return
        state_root = bytes(blk.message.state_root)
        # the anchor state must survive every prune: it is excluded from
        # droppable while it IS the finalized root, but pin a cold copy so
        # a restart long after further finality still finds it
        if chain.store.cold.get(DBColumn.BEACON_STATE, state_root) is None:
            st = chain._states.get(finalized.root)
            if st is None:
                st = chain.store.get_state(state_root)
            if st is not None:
                chain.store.put_cold_state(state_root, st)
        chain.store.set_anchor_info(
            int(blk.message.slot), bytes(finalized.root), state_root
        )
        just = chain.justified_checkpoint
        chain.store.put_fork_choice_snapshot(
            json.dumps(
                {
                    "head_root": chain.head_root.hex(),
                    "finalized_epoch": int(finalized.epoch),
                    "finalized_root": bytes(finalized.root).hex(),
                    "justified_epoch": int(just.epoch),
                    "justified_root": bytes(just.root).hex(),
                }
            ).encode()
        )

    # -- restore-point reconstruction -------------------------------------

    def reconstruct_state(self, block_root: bytes):
        """Post-state of a pre-split block: nearest-ancestor restore
        point + forward block replay (the chain's `_replay_state` base
        search already falls through to the cold DB, where the restore
        points live). Results land in a bounded LRU — range reads walk
        neighbouring slots, so the same restore-point replay would
        otherwise repeat per lookup. Returned states are shared,
        read-only by convention (same contract as the snapshot cache)."""
        block_root = bytes(block_root)
        with self._recon_lock:
            state = self._recon_cache.get(block_root)
            if state is not None:
                self._recon_cache.move_to_end(block_root)
                return state
        with span("store_reconstruct"):
            state = self.chain._replay_state(block_root)
        if state is None:
            return None
        inc_counter("store_states_reconstructed_total")
        with self._recon_lock:
            self._recon_cache[block_root] = state
            self._recon_cache.move_to_end(block_root)
            while len(self._recon_cache) > self._recon_cache_size:
                self._recon_cache.popitem(last=False)
        return state
