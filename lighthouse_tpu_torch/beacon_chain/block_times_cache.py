"""Per-block latency attribution, anchored to the slot clock.

The beacon_chain/src/block_times_cache.rs analog: timestamps each block's
pipeline milestones keyed by block root, exposes the inter-stage deltas
AND the delay-from-slot-start of every milestone as histograms, and
prunes with finality. The full milestone chain mirrors the reference's
`beacon_block_delay_*` suite:

    observed → gossip_verified → signature_verified → payload_verified
             → imported → became_head

Each milestone records two numbers: a monotonic timestamp (inter-stage
deltas are monotonic-minus-monotonic, immune to wall-clock steps) and the
slot-anchored offset `slot_clock.slot_offset_seconds(block.slot)` at the
stamp instant — the "seconds after the block's slot started" axis the
reference hangs its famous late-block diagnostics on.

When a block becomes head LATER than the attestation deadline (1/3 into
its slot), `set_became_head` emits one structured WARNING with the whole
per-stage breakdown (the reference's "Delayed head block" log in
canonical_head.rs) so an operator can see at a glance which stage ate
the slot.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..metrics import REGISTRY, observe
from ..utils.logging import get_logger

log = get_logger("block_times")

#: milestone order — breakdown logs and delay attribution walk this chain
MILESTONES = (
    "observed",
    "gossip_verified",
    "signature_verified",
    "payload_verified",
    "imported",
    "became_head",
)

#: slot-anchored delay histograms need buckets spanning a whole slot (and
#: then some — a late block can become head several slots after its own)
_SLOT_DELAY_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0,
    8.0, 10.0, 12.0, 18.0, 24.0, 36.0,
)

#: eagerly registered so every series exists at zero for scrapers/bench
_SLOT_DELAY_HISTOGRAMS = {
    "observed": REGISTRY.histogram(
        "beacon_block_observed_slot_start_delay_seconds",
        "slot-start → first observation of the block",
        buckets=_SLOT_DELAY_BUCKETS,
    ),
    "gossip_verified": REGISTRY.histogram(
        "beacon_block_gossip_verified_slot_start_delay_seconds",
        "slot-start → gossip (structure + proposer signature) verification",
        buckets=_SLOT_DELAY_BUCKETS,
    ),
    "signature_verified": REGISTRY.histogram(
        "beacon_block_signature_verified_slot_start_delay_seconds",
        "slot-start → bulk signature verification done",
        buckets=_SLOT_DELAY_BUCKETS,
    ),
    "payload_verified": REGISTRY.histogram(
        "beacon_block_payload_verified_slot_start_delay_seconds",
        "slot-start → execution payload verified (trivial pre-merge)",
        buckets=_SLOT_DELAY_BUCKETS,
    ),
    "imported": REGISTRY.histogram(
        "beacon_block_imported_slot_start_delay_seconds",
        "slot-start → block fully imported (store + fork choice)",
        buckets=_SLOT_DELAY_BUCKETS,
    ),
    "became_head": REGISTRY.histogram(
        "beacon_block_head_slot_start_delay_seconds",
        "slot-start → block became the canonical head",
        buckets=_SLOT_DELAY_BUCKETS,
    ),
}


@dataclass
class BlockTimes:
    slot: int
    #: milestone -> monotonic stamp (time.monotonic timeline)
    stamps: dict = field(default_factory=dict)
    #: milestone -> seconds after the block's slot started at stamp time
    slot_offsets: dict = field(default_factory=dict)
    #: derived inter-stage + slot-anchored delays (seconds)
    all_delays: dict = field(default_factory=dict)

    # legacy single-field accessors (pre-milestone-chain API surface)
    @property
    def observed_at(self):
        return self.stamps.get("observed")

    @property
    def imported_at(self):
        return self.stamps.get("imported")

    @property
    def became_head_at(self):
        return self.stamps.get("became_head")

    def stage_breakdown_ms(self) -> dict:
        """milestone -> ms since the PREVIOUS stamped milestone — the
        per-stage attribution the late-head warning prints. Skips
        milestones that were never stamped (e.g. a sync-imported block
        has no gossip_verified)."""
        out = {}
        prev = None
        for m in MILESTONES:
            t = self.stamps.get(m)
            if t is None:
                continue
            if prev is not None:
                out[m] = round((t - prev) * 1000.0, 1)
            prev = t
        return out


class BlockTimesCache:
    MAX_ENTRIES = 64  # a few epochs of blocks; pruned with finality anyway

    def __init__(self, slot_clock=None, seconds_per_slot: int = 12):
        self._times: dict[bytes, BlockTimes] = {}
        #: None = slot anchoring disabled (delays stay monotonic-only)
        self.slot_clock = slot_clock
        self.seconds_per_slot = seconds_per_slot

    def _entry(self, block_root: bytes, slot: int) -> BlockTimes:
        e = self._times.get(block_root)
        if e is None:
            if len(self._times) >= self.MAX_ENTRIES:
                oldest = min(self._times, key=lambda r: self._times[r].slot)
                self._times.pop(oldest)
            e = BlockTimes(slot=slot)
            self._times[block_root] = e
        return e

    # -- milestones ------------------------------------------------------

    def stamp(self, milestone: str, block_root: bytes, slot: int, t: float):
        """Record one milestone at monotonic time `t` (first write wins —
        a block re-observed on a second gossip hop keeps its earliest
        stamp, and a segment re-import cannot rewrite history)."""
        if milestone not in _SLOT_DELAY_HISTOGRAMS:
            raise ValueError(f"unknown block milestone: {milestone}")
        e = self._entry(block_root, slot)
        if milestone in e.stamps:
            return
        e.stamps[milestone] = t
        if self.slot_clock is not None:
            off = self.slot_clock.slot_offset_seconds(slot)
            e.slot_offsets[milestone] = off
            e.all_delays[f"{milestone}_slot_start"] = off
            # clamp the histogram sample at 0: a block arriving within the
            # one-slot clock-disparity tolerance has a NEGATIVE offset,
            # which would drag the bucket counts/sum below their true
            # values (the entry keeps the signed offset for diagnostics)
            _SLOT_DELAY_HISTOGRAMS[milestone].observe(max(0.0, off))

    def set_observed(self, block_root: bytes, slot: int, t: float):
        self.stamp("observed", block_root, slot, t)

    def set_gossip_verified(self, block_root: bytes, slot: int, t: float):
        self.stamp("gossip_verified", block_root, slot, t)

    def set_signature_verified(self, block_root: bytes, slot: int, t: float):
        self.stamp("signature_verified", block_root, slot, t)

    def set_payload_verified(self, block_root: bytes, slot: int, t: float):
        self.stamp("payload_verified", block_root, slot, t)

    def set_imported(self, block_root: bytes, slot: int, t: float):
        self.stamp("imported", block_root, slot, t)
        # _entry, not a raw subscript: a concurrent set_observed from the
        # gossip thread can evict this root at MAX_ENTRIES between the
        # stamp and the re-read (the cache is deliberately lock-free)
        e = self._entry(block_root, slot)
        obs = e.stamps.get("observed")
        if obs is not None:
            delay = t - obs
            e.all_delays["observed_to_imported"] = delay
            observe("beacon_block_observed_to_imported_seconds", delay)

    def set_became_head(self, block_root: bytes, slot: int, t: float):
        # NOT first-write-only on the derived delay: re-orgs can make the
        # same block head again, but the stamp itself stays the earliest
        self.stamp("became_head", block_root, slot, t)
        e = self._entry(block_root, slot)  # see set_imported: eviction race
        imp = e.stamps.get("imported")
        if imp is not None and "imported_to_head" not in e.all_delays:
            delay = t - imp
            e.all_delays["imported_to_head"] = delay
            observe("beacon_block_imported_to_head_seconds", delay)
        self._maybe_log_late_head(block_root, e)

    def _attestation_deadline(self) -> float:
        """The clock owns the deadline definition; a clock-less cache
        (unit tests) falls back to thirds of its own seconds_per_slot."""
        if self.slot_clock is not None:
            return self.slot_clock.attestation_deadline_offset
        return self.seconds_per_slot / 3

    def _maybe_log_late_head(self, block_root: bytes, e: BlockTimes):
        """The reference's "block was late" diagnostic: a block that
        became head after the attestation deadline (1/3 slot) gets one
        WARNING carrying the whole per-stage breakdown."""
        off = e.slot_offsets.get("became_head")
        if off is None or off <= self._attestation_deadline():
            return
        # near-live blocks only: during range-sync catch-up EVERY imported
        # block is hours "late" relative to its own slot — the reference
        # likewise only shouts about lateness at the head of the chain
        if self.slot_clock is not None and self.slot_clock.now() - e.slot > 1:
            return
        log.warning(
            "late head block",
            root=block_root.hex()[:12],
            slot=e.slot,
            head_slot_offset_s=round(off, 3),
            deadline_s=round(self._attestation_deadline(), 3),
            observed_slot_offset_s=round(
                e.slot_offsets.get("observed", float("nan")), 3
            ),
            **{f"stage_{k}_ms": v for k, v in e.stage_breakdown_ms().items()},
        )

    # -- queries ---------------------------------------------------------

    def get(self, block_root: bytes) -> BlockTimes | None:
        return self._times.get(block_root)

    def prune(self, finalized_slot: int):
        for root in [
            r for r, e in self._times.items() if e.slot < finalized_slot
        ]:
            self._times.pop(root)
