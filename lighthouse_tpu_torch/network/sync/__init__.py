"""Sync engine (network/src/sync/): range sync, backfill, block lookups.

The third pillar of the network layer next to gossipsub and the RPC
codec. The old inline `SyncManager` was a single-peer, sequential,
zero-retry loop — any peer fault stalled it or silently gave up. This
package replaces it with the reference's shape (sync/manager.rs as the
router, range_sync/ + backfill_sync/ + block_lookups/ as the engines):

  * `range_sync` — a per-batch state machine over epoch windows,
    downloading from multiple peers concurrently with timeouts, capped
    peer-rotating retries, exponential backoff, and downscoring of peers
    whose batches fail hash-chain or import validation. Processing rides
    the beacon_processor's CHAIN_SEGMENT queue.
  * `backfill` — the backward history walk as a resumable state machine:
    persisted (oldest slot, expected root) watermark, per-window retry
    across peers, downscore on unlinked windows, storage through the
    BACKFILL_SYNC queue.
  * `block_lookups` — unknown-root recovery for gossip: capped ancestor
    walks via blocks_by_root, de-duplicated in-flight requests, and
    reprocess-queue release of held attestations on import.
  * `network_context` — request ids, per-peer in-flight accounting, and
    blob-sidecar coupling shared by all three.
  * `service` — the autonomous Status-listening loop (sync/manager.rs
    main-loop role): watches peer heads, starts/stops range-sync
    catch-up by itself with capped backoff between failed runs — the
    node path has no `sync_to_head` callers anymore.

Everything is metered: the `sync_state` gauge, per-chain
`sync_batch_{downloads,retries,failures}_total`, `sync_lookup_*`
counters, and `sync_range_batch`/`sync_backfill_batch` tracing spans —
all series eagerly registered so dashboards see zeros, not gaps.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...metrics import REGISTRY, inc_counter, set_gauge
from ...utils.logging import get_logger
from ..rpc import RpcError
from .backfill import BackfillSync, verify_backfill_signatures
from .batch import Batch, BatchState
from .block_lookups import BlockLookups
from .network_context import SyncNetworkContext
from .range_sync import SyncingChain
from .service import SyncService

__all__ = [
    "Batch",
    "BatchState",
    "BackfillSync",
    "BlockLookups",
    "SyncConfig",
    "SyncManager",
    "SyncNetworkContext",
    "SyncService",
    "SyncingChain",
    "verify_backfill_signatures",
]

log = get_logger("lighthouse_tpu_torch.sync")

# sync_state gauge values (SyncState in sync/manager.rs)
SYNC_STATE_STALLED = 0
SYNC_STATE_SYNCED = 1
SYNC_STATE_RANGE = 2
SYNC_STATE_BACKFILL = 3


def set_sync_state(value: int):
    set_gauge("sync_state", value)


def _register_metrics():
    """Eager registration: /metrics consumers rely on every sync series
    existing at zero before the first fault."""
    for chain in ("range", "backfill"):
        REGISTRY.counter("sync_batch_downloads_total").inc(0, chain=chain)
        REGISTRY.counter("sync_batch_retries_total").inc(0, chain=chain)
        REGISTRY.counter("sync_batch_failures_total").inc(0, chain=chain)
    for kind in ("single", "parent"):
        REGISTRY.counter("sync_lookups_started_total").inc(0, kind=kind)
    REGISTRY.counter("sync_lookups_completed_total").inc(0)
    REGISTRY.counter("sync_lookups_failed_total").inc(0)
    REGISTRY.counter("sync_lookup_reprocess_drained_total").inc(0)
    REGISTRY.counter(
        "sync_fork_backtracks_total",
        "range-sync runs restarted from the finalized boundary after "
        "batch 0 hit an unknown parent (local head on a competing fork)",
    ).inc(0)
    for method in ("blocks_by_range", "blocks_by_root", "blob_sidecars_by_root"):
        REGISTRY.counter("sync_rpc_requests_total").inc(0, method=method)
    set_gauge("sync_state", SYNC_STATE_STALLED)


_register_metrics()


@dataclass
class SyncConfig:
    """Retry/backoff knobs (tests shrink the time constants)."""

    #: slots per batch = epochs_per_batch * SLOTS_PER_EPOCH
    #: (BLOCKS_BY_RANGE batch sizing, range_sync/chain.rs EPOCHS_PER_BATCH)
    epochs_per_batch: int = 2
    #: concurrent batch downloads across the peer pool
    max_parallel_downloads: int = 4
    #: download attempts per batch before the chain fails
    max_download_attempts: int = 5
    #: processing failures / validation rollbacks per batch before failing
    max_process_attempts: int = 3
    #: exponential backoff: base * 2^(attempt-1), capped at max
    backoff_base_s: float = 0.05
    backoff_max_s: float = 1.0
    #: per-batch download deadline; slower peers are rotated out
    batch_timeout_s: float = 10.0
    #: hard wall for one range-sync run (stall insurance)
    chain_timeout_s: float = 120.0
    #: ancestor-walk cap for parent lookups (deeper chains belong to
    #: range sync, block_lookups PARENT_DEPTH_TOLERANCE)
    lookup_max_depth: int = 8
    #: per-root fetch attempts across rotated peers
    lookup_max_attempts: int = 3


class SyncManager:
    """The sync/manager.rs router: owns the shared network context and the
    three engines, and fronts them with the entry points the node calls
    (Status-driven range sync, checkpoint backfill, gossip unknown-root
    recovery)."""

    def __init__(self, service, config: SyncConfig | None = None):
        self.service = service
        self.config = config or SyncConfig()
        self.ctx = SyncNetworkContext(service)
        self.lookups = BlockLookups(service, self.ctx, self.config)
        self.backfill_sync = BackfillSync(service, self.ctx, self.config)

    def stop(self):
        self.lookups.stop()

    # -- range sync --------------------------------------------------------

    def sync_with(self, peer) -> int:
        """Catch up using one peer (Status handshake first). Single-peer
        entry kept for the dial path — the engine underneath is the same
        batch state machine, so faults still retry/backoff instead of
        stalling."""
        status = peer.client.status(self.service.local_status())
        peer.status = status
        return self._range_sync([peer], int(status.head_slot))

    def poll_sync_candidates(self, peers=None):
        """One Status round-trip per peer → (candidates, serving, target):
        every peer that answered (status refreshed in place), the subset
        advertising a head PAST ours — only those serve catch-up batches;
        a behind/at-head peer hands every range window an empty batch,
        which "succeeds" with zero blocks and starves the real download —
        and the best advertised head. Shared by `sync_to_head` and the
        autonomous SyncService so candidate policy can't diverge."""
        candidates = []
        for p in peers if peers is not None else self.service.peers.peers():
            try:
                p.status = p.client.status(self.service.local_status())
            except (RpcError, OSError):
                continue
            candidates.append(p)
        if not candidates:
            return [], [], 0
        target = max(int(p.status.head_slot) for p in candidates)
        head = int(self.service.chain.head_state.slot)
        serving = [p for p in candidates if int(p.status.head_slot) > head]
        return candidates, serving, target

    def sync_to_head(self, peers=None) -> int:
        """Multi-peer range sync to the best head the peer set advertises.
        Peers whose Status request fails (stale/dead) are dropped from the
        candidate pool instead of wedging the run. Test entry point:
        the NODE path never calls this — the autonomous SyncService polls
        Statuses and drives `_range_sync` itself."""
        candidates, serving, target = self.poll_sync_candidates(peers)
        if not candidates:
            return 0
        return self._range_sync(serving, target)

    def _range_sync(self, peers, target_slot: int) -> int:
        chain = self.service.chain
        # a Status head_slot is attacker-controlled (uint64): clamp to the
        # wall clock — blocks past the current slot are invalid anyway,
        # and the batch map must never be sized by a peer's claim
        target_slot = min(int(target_slot), int(chain.slot_clock.now()))
        if target_slot <= chain.head_state.slot:
            set_sync_state(SYNC_STATE_SYNCED)
            return 0
        set_sync_state(SYNC_STATE_RANGE)
        imported = 0
        start_slot = int(chain.head_state.slot) + 1
        try:
            for _attempt in range(2):
                syncing = SyncingChain(
                    self.service,
                    self.ctx,
                    peers,
                    start_slot=start_slot,
                    target_slot=target_slot,
                    config=self.config,
                )
                imported += syncing.run()
                if not syncing.fork_suspected:
                    break
                # batch 0 hit an unknown parent: our head sits on a fork
                # of the serving peers' chain. Restart ONCE from the
                # finalized boundary — the shared prefix re-downloads and
                # skips at import, and the competing chain attaches at
                # its true branch point (range_sync/chain.rs syncs from
                # the finalized epoch for exactly this reason). Without
                # this, every retry indicted an honest peer until whole
                # healed partitions were banned.
                from ...state_processing.accessors import (
                    compute_start_slot_at_epoch,
                )

                fin_start = compute_start_slot_at_epoch(
                    int(chain.finalized_checkpoint.epoch), chain.E
                )
                backtrack = max(int(chain.anchor_slot), fin_start) + 1
                if backtrack >= start_slot:
                    break  # already at the boundary: a genuinely bad span
                inc_counter("sync_fork_backtracks_total")
                log.info(
                    "range sync backtracking to finalized boundary",
                    from_slot=start_slot,
                    to_slot=backtrack,
                    target=target_slot,
                )
                start_slot = backtrack
        finally:
            set_sync_state(
                SYNC_STATE_SYNCED
                if chain.head_state.slot >= target_slot
                else SYNC_STATE_STALLED
            )
        return imported

    # -- backfill ----------------------------------------------------------

    def backfill(
        self,
        peer=None,
        peers=None,
        verify_signatures: bool = True,
        max_batches=None,
    ) -> int:
        """Backfill pre-anchor history. `peer` keeps the old single-peer
        call shape; `peers` (or the connected set) enables rotation."""
        pool = (
            [peer]
            if peer is not None
            else (peers if peers is not None else self.service.peers.peers())
        )
        if not pool:
            return 0
        return self.backfill_sync.run(
            pool, verify_signatures=verify_signatures, max_batches=max_batches
        )

    # -- gossip recovery ---------------------------------------------------

    def on_unknown_parent_block(self, signed_block) -> bool:
        """A gossip block whose parent fork choice doesn't know: recover
        the ancestry instead of penalizing the forwarder."""
        return self.lookups.search_parent(signed_block)

    def on_unknown_block_root(self, block_root: bytes) -> bool:
        """Gossip referenced a root we don't have (attestation head)."""
        return self.lookups.search_block(block_root)

    # -- the old sequential loop (control / oracle) ------------------------

    def sequential_sync_with(self, peer) -> int:
        """The pre-engine single-peer loop, verbatim semantics: one batch
        at a time, no retries, no timeouts, first fault stops the sync.
        Kept as a control and as a differential oracle for the engine."""
        service = self.service
        chain = service.chain
        status = peer.client.status(service.local_status())
        peer.status = status
        imported_total = 0
        batch = self.config.epochs_per_batch * chain.E.SLOTS_PER_EPOCH
        while int(status.head_slot) > chain.head_state.slot:
            start = chain.head_state.slot + 1
            blocks = peer.client.blocks_by_range(
                start, batch, service.decode_block
            )
            if not blocks:
                break
            self.ctx.couple_blob_sidecars(peer, blocks)
            result = chain.process_chain_segment(blocks)
            imported_total += result.imported
            inc_counter("sync_blocks_imported_total", amount=result.imported)
            if result.error is not None:
                from .. import SCORE_INVALID_MESSAGE

                service.peers.report(peer.peer_id, SCORE_INVALID_MESSAGE)
                break
            if result.imported == 0:
                break
        return imported_total
