"""Multi-peer range sync over a chain of epoch-batches.

The sync/range_sync/chain.rs analog: a `SyncingChain` covers
[local head + 1, target] with `EPOCHS_PER_BATCH`-epoch `Batch` windows and
drives each through the batch state machine (batch.py). Downloads run on
worker threads against *multiple peers concurrently* (per-peer in-flight
accounting picks the idlest peer, batches rotate away from peers that
failed them); processing is strictly ordered and rides the
beacon_processor's CHAIN_SEGMENT queue so imports share the node's one
prioritized worker pool.

Fault handling, the point of the subsystem:
  * download failure (RPC error / timeout / hash-chain break) — capped
    retries with exponential backoff, each retry on a rotated peer;
    hash-chain breaks downscore the serving peer immediately.
  * processing failure — the failed batch AND every batch still awaiting
    validation roll back to Queued: a truncated/forked batch imports as a
    clean prefix and only betrays itself when its successor hits an
    unknown parent, so suspicion lands on the whole unvalidated span. The
    directly-failed batch's peer takes a full invalid-message downscore,
    rolled-back peers a half (they are implicated, not convicted).
  * retry budgets exhausted — the batch goes Failed and the chain stops,
    returning what it imported (the caller may retry with fresh peers).
"""

from __future__ import annotations

import threading
import time

from ...beacon_processor import WorkType
from ...metrics import inc_counter
from ...utils.logging import get_logger
from ...utils.tracing import span
from ..rpc import RpcError
from .batch import ACTIVE_STATES, Batch, BatchState, check_hash_chain

log = get_logger("lighthouse_tpu_torch.sync.range")


class SyncingChain:
    def __init__(self, service, ctx, peers, start_slot, target_slot, config):
        self.service = service
        self.ctx = ctx
        self.cfg = config
        self.chain = service.chain
        self.peers = {p.peer_id: p for p in peers}
        self.target_slot = int(target_slot)
        self._cv = threading.Condition()
        self._downloads = 0
        self.imported = 0
        self.failed = False
        #: set when batch 0 failed import on an unknown PARENT: the span
        #: starts above our fork's branch point, so the serving peer may
        #: be honestly serving a COMPETING canonical chain — the caller
        #: should restart from the finalized boundary instead of letting
        #: retries indict (and eventually ban) half the network
        self.fork_suspected = False
        self.batches: dict[int, Batch] = {}
        batch_span = config.epochs_per_batch * self.chain.E.SLOTS_PER_EPOCH
        s = int(start_slot)
        bid = 0
        while s <= self.target_slot:
            count = min(batch_span, self.target_slot - s + 1)
            self.batches[bid] = Batch(id=bid, start_slot=s, count=count)
            bid += 1
            s += count

    # -- main loop ---------------------------------------------------------

    def run(self, timeout: float | None = None) -> int:
        """Drive the chain to completion (or failure/timeout); returns the
        number of blocks imported."""
        deadline = time.monotonic() + (
            timeout if timeout is not None else self.cfg.chain_timeout_s
        )
        with self._cv:
            while not self.failed and not self._complete_locked():
                if self.service._stopping or time.monotonic() > deadline:
                    self.failed = True
                    break
                if not self._alive_peers():
                    self.failed = True  # every peer banned/disconnected
                    break
                self._launch_downloads_locked()
                self._submit_processing_locked()
                self._cv.wait(timeout=0.02)
            # downloads still in flight keep running as daemons; their
            # results land in batches nobody reads again
        return self.imported

    def _complete_locked(self) -> bool:
        return not any(b.state in ACTIVE_STATES for b in self.batches.values())

    def _alive_peers(self) -> list:
        out = []
        for pid in list(self.peers):
            if self.service.peers.get(pid) is None:
                continue  # banned or dropped
            out.append(self.peers[pid])
        return out

    # -- downloads ---------------------------------------------------------

    def _select_peer(self, batch: Batch):
        """Best peer for a (re)download, ranked by the shared policy
        (ctx.select_peer). Strikes are the per-BATCH failure counts (not
        a yes/no set): that keeps rotation live once every peer has one
        strike — a consistently-dead peer accumulates strikes and yields
        to the peer that failed least, instead of winning the tiebreak
        forever on its untouched score. A lone flaky peer still gets its
        retries."""
        return self.ctx.select_peer(
            self.peers.values(), strikes=batch.failed_peers
        )

    def _launch_downloads_locked(self):
        now = time.monotonic()
        for batch in sorted(self.batches.values(), key=lambda b: b.id):
            if self._downloads >= self.cfg.max_parallel_downloads:
                return
            if not batch.ready_at(now):
                continue
            peer = self._select_peer(batch)
            if peer is None:
                return
            batch.state = BatchState.DOWNLOADING
            batch.peer_id = peer.peer_id
            self._downloads += 1
            threading.Thread(
                target=self._download_worker,
                args=(batch, peer),
                daemon=True,
                name=f"sync-dl-{batch.id}",
            ).start()

    def _download_worker(self, batch: Batch, peer):
        from .. import SCORE_INVALID_MESSAGE, SCORE_RPC_FAILURE

        inc_counter("sync_batch_downloads_total", chain="range")
        t0 = time.monotonic()
        blocks = None
        err = None
        with span("sync_range_batch", batch=batch.id, start=batch.start_slot):
            try:
                blocks = self.ctx.blocks_by_range(
                    peer, batch.start_slot, batch.count
                )
            except (RpcError, OSError) as e:
                err = f"download failed: {e}"
                self.service.peers.report(peer.peer_id, SCORE_RPC_FAILURE)
        if err is None and time.monotonic() - t0 > self.cfg.batch_timeout_s:
            # slow peer: the data arrived but past the batch deadline —
            # discard it and rotate, exactly as a request timeout would
            err = "download timed out"
            self.service.peers.report(peer.peer_id, SCORE_RPC_FAILURE)
        if err is None:
            chain_err = check_hash_chain(blocks, batch.start_slot, batch.count)
            if chain_err is not None:
                err = chain_err
                self.service.peers.report(peer.peer_id, SCORE_INVALID_MESSAGE)
        if err is None and blocks:
            try:
                self.ctx.couple_blob_sidecars(peer, blocks)
            except (RpcError, OSError):
                pass  # affected blocks fail their DA gate at import
        with self._cv:
            self._downloads -= 1
            if err is None:
                batch.blocks = blocks
                batch.state = BatchState.AWAITING_PROCESSING
            else:
                log.info(
                    "sync batch download failed",
                    batch=batch.id,
                    peer=peer.peer_id,
                    error=err[:120],
                )
                inc_counter("sync_batch_retries_total", chain="range")
                batch.record_download_failure(
                    self.cfg.backoff_base_s, self.cfg.backoff_max_s
                )
                if batch.download_failures >= self.cfg.max_download_attempts:
                    batch.state = BatchState.FAILED
                    self.failed = True
                    inc_counter("sync_batch_failures_total", chain="range")
            self._cv.notify_all()

    # -- processing --------------------------------------------------------

    def _submit_processing_locked(self):
        """Feed the lowest unprocessed batch to the CHAIN_SEGMENT queue —
        processing is strictly ordered (each batch's parents come from its
        predecessor), downloads are not."""
        for batch in sorted(self.batches.values(), key=lambda b: b.id):
            if batch.state in (
                BatchState.AWAITING_VALIDATION,
                BatchState.VALIDATED,
            ):
                continue
            if batch.state is not BatchState.AWAITING_PROCESSING:
                return  # predecessor still downloading/queued/processing
            batch.state = BatchState.PROCESSING
            if not self.service.processor.submit(
                WorkType.CHAIN_SEGMENT, batch, self._process_handler
            ):
                batch.state = BatchState.AWAITING_PROCESSING  # queue full
            return

    def _process_handler(self, batch: Batch):
        """Runs on a beacon_processor worker. The processing phase gets
        its own `sync_range_batch` trace (phase=process; the download
        phase's trace lives on the sync-dl thread): segment-import spans
        nest under it, and the stack profiler attributes the worker's
        samples to the sync_range_batch root instead of "unattributed" —
        the submit happens span-less on the state-machine thread, so
        without this root the copy_context hop carries nothing."""
        with span(
            "sync_range_batch", batch=batch.id, start=batch.start_slot,
            phase="process",
        ):
            self._process_batch(batch)

    def _process_batch(self, batch: Batch):
        from ...beacon_chain.chain import BlockError, ChainSegmentResult

        chain = self.chain
        blocks = list(batch.blocks or ())
        # rollbacks re-download windows whose prefix already imported —
        # skip known blocks so the segment replay (and the imported count)
        # only covers new work
        while blocks and chain.fork_choice.contains_block(
            blocks[0].message.hash_tree_root()
        ):
            blocks.pop(0)
        if blocks:
            try:
                result = chain.process_chain_segment(blocks)
            except Exception as e:  # noqa: BLE001 — worker must report, not die
                result = ChainSegmentResult(imported=0, error=BlockError(str(e)))
        else:
            result = ChainSegmentResult(imported=0)
        if result.imported:
            inc_counter("sync_blocks_imported_total", amount=result.imported)
        with self._cv:
            batch.result = result
            self.imported += result.imported
            if result.error is None:
                batch.state = BatchState.AWAITING_VALIDATION
                # only a NON-EMPTY clean successor validates its
                # predecessors: its first block's parent link is the
                # evidence. An all-skipped-slots batch "succeeds" with
                # zero blocks and proves nothing — promoting on it would
                # make a truncated predecessor unrecoverable.
                if blocks:
                    for b in self.batches.values():
                        if (
                            b.id < batch.id
                            and b.state is BatchState.AWAITING_VALIDATION
                        ):
                            b.state = BatchState.VALIDATED
            else:
                self._processing_failed_locked(batch, result)
            self._cv.notify_all()

    def _processing_failed_locked(self, batch: Batch, result):
        from .. import SCORE_INVALID_MESSAGE

        log.info(
            "sync batch processing failed",
            batch=batch.id,
            peer=batch.peer_id,
            error=str(result.error)[:120],
        )
        # Batch 0 failing on "parent unknown" means the CHAIN's start
        # slot sits above a fork's branch point — our head is not on the
        # peer's canonical chain. That indicts our window placement, not
        # the peer: it honestly served its chain (the post-partition heal
        # scenario banned entire healed halves through this downscore).
        # Flag it, fail the run fast (no retry — so no retry counter),
        # and let the manager restart from the finalized boundary.
        if batch.id == 0 and "parent unknown" in str(result.error):
            self.fork_suspected = True
            batch.state = BatchState.FAILED
            self.failed = True
            inc_counter("sync_batch_failures_total", chain="range")
            return
        inc_counter("sync_batch_retries_total", chain="range")
        # the failed batch's peer is directly implicated (invalid block,
        # or a first block whose parent nobody delivered)
        if batch.peer_id is not None:
            self.service.peers.report(batch.peer_id, SCORE_INVALID_MESSAGE)
        batch.record_rollback(self.cfg.backoff_base_s, self.cfg.backoff_max_s)
        # batches awaiting validation are implicated too: one of them may
        # have served a truncated/forked prefix that only now surfaced.
        # Half downscore — implicated, not convicted — and a re-download
        # from a rotated peer.
        for b in self.batches.values():
            if b.state is BatchState.AWAITING_VALIDATION:
                if b.peer_id is not None:
                    self.service.peers.report(
                        b.peer_id, SCORE_INVALID_MESSAGE / 2
                    )
                b.record_rollback(
                    self.cfg.backoff_base_s, self.cfg.backoff_max_s
                )
        for b in self.batches.values():
            if b.process_attempts >= self.cfg.max_process_attempts:
                b.state = BatchState.FAILED
                self.failed = True
                inc_counter("sync_batch_failures_total", chain="range")
