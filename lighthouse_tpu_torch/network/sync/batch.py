"""Per-batch sync state machine (sync/range_sync/batch.rs).

A batch is one contiguous slot window of a syncing chain. Its lifecycle:

    Queued -> Downloading -> AwaitingProcessing -> Processing
           -> AwaitingValidation -> Validated
                        \\-> (download/processing failure) -> Queued (retry)
                        \\-> Failed (retry budget exhausted)

`AwaitingValidation` is the load-bearing state: a batch that *processed*
cleanly is still only provisionally good — a truncated or forked batch can
import as a valid prefix and only betray itself when the NEXT batch fails
with an unknown parent. Validation happens when a later batch processes
successfully; until then the batch keeps its serving peer on the hook so a
rollback can re-download it from someone else (the reference keeps exactly
this state for the same reason, batch.rs:1-40).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field


class BatchState(enum.Enum):
    QUEUED = "queued"
    DOWNLOADING = "downloading"
    AWAITING_PROCESSING = "awaiting_processing"
    PROCESSING = "processing"
    AWAITING_VALIDATION = "awaiting_validation"
    VALIDATED = "validated"
    FAILED = "failed"


#: states that still need work before the chain can complete
ACTIVE_STATES = frozenset(
    {
        BatchState.QUEUED,
        BatchState.DOWNLOADING,
        BatchState.AWAITING_PROCESSING,
        BatchState.PROCESSING,
    }
)


@dataclass
class Batch:
    """One epoch-aligned slot window of a syncing chain."""

    id: int
    start_slot: int
    count: int
    state: BatchState = BatchState.QUEUED
    #: peer currently (or last) serving this batch — the one a processing
    #: failure implicates
    peer_id: str | None = None
    #: peer id -> times it failed this batch (rotation prefers the
    #: least-failed peer, so a consistently-dead peer can't monopolize
    #: the retry budget once every peer has one strike)
    failed_peers: dict = field(default_factory=dict)
    #: failed download attempts (RPC error / timeout / hash-chain break)
    download_failures: int = 0
    #: processing failures + validation rollbacks
    process_attempts: int = 0
    #: earliest monotonic time the next download may start (backoff)
    retry_at: float = 0.0
    blocks: list | None = None
    result: object = None

    @property
    def end_slot(self) -> int:
        """One past the last slot of the window."""
        return self.start_slot + self.count

    def ready_at(self, now: float) -> bool:
        return self.state is BatchState.QUEUED and self.retry_at <= now

    def _mark_peer_failed(self):
        if self.peer_id is not None:
            self.failed_peers[self.peer_id] = (
                self.failed_peers.get(self.peer_id, 0) + 1
            )

    def record_download_failure(self, backoff_base: float, backoff_max: float):
        """Failed download: count the attempt, remember the peer, arm the
        exponential backoff clock."""
        self.download_failures += 1
        self._mark_peer_failed()
        delay = min(backoff_max, backoff_base * (2 ** (self.download_failures - 1)))
        self.retry_at = time.monotonic() + delay
        self.state = BatchState.QUEUED
        self.blocks = None

    def record_rollback(self, backoff_base: float, backoff_max: float):
        """Processing failure (its own, or a later batch implicating it):
        back to Queued for a fresh download from a rotated peer."""
        self.process_attempts += 1
        self._mark_peer_failed()
        delay = min(backoff_max, backoff_base * (2 ** (self.process_attempts - 1)))
        self.retry_at = time.monotonic() + delay
        self.state = BatchState.QUEUED
        self.blocks = None
        self.result = None


def check_hash_chain(blocks, start_slot: int, count: int) -> str | None:
    """Download-time batch sanity: slots strictly ascending inside the
    requested window, and consecutive blocks parent-linked. A peer whose
    batch fails this served forked/garbled data — it is downscored before
    the batch ever reaches the import pipeline. Gaps (skipped slots) are
    legal; cross-batch linkage is the import stage's job. Returns an error
    string, or None when the batch is well-formed."""
    prev_slot = None
    prev_root = None
    for signed in blocks:
        slot = int(signed.message.slot)
        if not (start_slot <= slot < start_slot + count):
            return f"block at slot {slot} outside window [{start_slot}, {start_slot + count})"
        if prev_slot is not None:
            if slot <= prev_slot:
                return f"slots not ascending ({prev_slot} -> {slot})"
            if bytes(signed.message.parent_root) != prev_root:
                return f"hash chain broken at slot {slot}"
        prev_slot = slot
        prev_root = signed.message.hash_tree_root()
    return None
