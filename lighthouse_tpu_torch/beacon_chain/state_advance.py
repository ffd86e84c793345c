"""Next-slot state pre-computation.

The beacon_chain/src/state_advance_timer.rs analog (:1-15): shortly before
each slot boundary the head state is advanced through the upcoming slot
(epoch processing included — the expensive part at epoch boundaries) and
cached, so block production and the first gossip verification of the new
slot start from a pre-built state instead of paying the advance on the
hot path. The chain's `_pre_state_for` and `produce_block_on_state`
consult the cache keyed by (head_root, target_slot).

The advance rides its OWN beacon_processor lane when a processor is
offered (`WorkType.STATE_ADVANCE`, just above the slasher's): the
NetworkService slot tick submits the advance instead of running it
inline, so the epoch transition — ~hundreds of ms at 1M validators —
lands on a worker thread with free queue-wait/run histograms, never on
the heartbeat thread or a gossip reader. Slot claims are atomic, so the
client slot timer and the network slot tick can both fire without
double-advancing a slot.

Cache discipline: `get` hands out a CoW copy and RETAINS the entry
(tree-states copies are ~0.13 ms at 1M validators), so the proposal path
and the subsequent import of that same proposal both hit one pre-advance.
Every entry ends life in exactly one counter bucket: `hits` when first
consumed, `wasted` when dropped (head change, replacement, or a
mid-advance head move) without ever being consumed.
"""

from __future__ import annotations

import threading

from ..metrics import REGISTRY, inc_counter, start_timer
from ..state_processing import per_slot_processing
from ..utils.logging import get_logger

log = get_logger("state_advance")

# Eager registration: dashboards difference hits/misses/wasted from boot,
# and the conftest metric guard asserts the series exist at zero.
REGISTRY.counter(
    "state_advance_hits_total",
    "pre-advanced snapshots consumed by production or import",
).inc(0)
REGISTRY.counter(
    "state_advance_misses_total",
    "snapshot lookups that found no matching pre-advance",
).inc(0)
REGISTRY.counter(
    "state_advance_wasted_total",
    "pre-advances discarded without ever being consumed",
).inc(0)

# The block_production trace-root + child-stage histograms must exist at
# zero: the block-production bench reads the stage breakdown eagerly and
# the conftest guard asserts the series (same pattern as the fork-choice
# get_head stages).
for _span_name in (
    "trace_span_seconds_block_production",
    "trace_span_seconds_advance",
    "trace_span_seconds_pack",
    "trace_span_seconds_assemble",
    "trace_span_seconds_sign",
):
    REGISTRY.histogram(
        # lint: allow(metric-hygiene) -- bounded by the literal tuple above
        _span_name,
        "span duration: block production stage",
    )


class StateAdvanceCache:
    """(head_root, target_slot) -> pre-advanced state. One entry — only
    the next slot off the current head is worth keeping
    (state_advance_timer advances at most 1 slot past the head for the
    same reason).

    `get` returns a CoW copy and keeps the entry live so multiple
    consumers of the same (head, slot) — the proposer and then the import
    of its own block — each get an isolated state."""

    def __init__(self):
        self._lock = threading.Lock()
        self._key: tuple[bytes, int] | None = None
        self._state = None
        self._consumed = False

    def put(self, head_root: bytes, slot: int, state):
        with self._lock:
            if self._state is not None and not self._consumed:
                inc_counter("state_advance_wasted_total")
            self._key = (bytes(head_root), int(slot))
            self._state = state
            self._consumed = False

    def get(self, head_root: bytes, slot: int):
        """CoW copy of the cached state if it matches; the entry stays
        cached for further consumers keyed off the same head."""
        with self._lock:
            if (
                self._state is not None
                and self._key == (bytes(head_root), int(slot))
            ):
                if not self._consumed:
                    self._consumed = True
                    inc_counter("state_advance_hits_total")
                return self._state.copy()
            inc_counter("state_advance_misses_total")
            return None

    def invalidate(self, new_head_root: bytes | None = None):
        """Drop the entry on a head change. With `new_head_root`, an
        entry keyed off that same head survives (its pre-advance is still
        the one the next proposal wants)."""
        with self._lock:
            if self._state is None:
                return
            if (
                new_head_root is not None
                and self._key is not None
                and self._key[0] == bytes(new_head_root)
            ):
                return
            if not self._consumed:
                inc_counter("state_advance_wasted_total")
            self._key = None
            self._state = None
            self._consumed = False

    def clear(self):
        """Reset without wasted-accounting (bench/test hygiene)."""
        with self._lock:
            self._key = None
            self._state = None
            self._consumed = False


class StateAdvanceTimer:
    """Drives the pre-advance once per slot; call `on_slot_tick` from the
    slot timer at the advance fraction (the reference fires at 3/4 into
    the slot). Attaches itself as `chain.state_advance_timer` so the
    network slot tick can reach it without plumbing."""

    def __init__(self, chain):
        self.chain = chain
        self._last_slot = -1
        self._slot_lock = threading.Lock()
        # advances must never overlap: per_slot_processing mutates the
        # working copy, and a backlogged STATE_ADVANCE queue (or the
        # inline fallback racing a queued run) could otherwise hand two
        # slots to two workers at once
        self._run_lock = threading.Lock()
        chain.state_advance_timer = self

    # -- slot claim (client timer and network tick both fire) ------------

    def _claim_slot(self, slot: int) -> bool:
        """Atomically claim `slot`: exactly one of the competing slot
        callers (client timer, network slot tick) wins."""
        with self._slot_lock:
            if slot <= self._last_slot:
                return False
            self._last_slot = slot
            return True

    def _unclaim_slot(self, slot: int):
        with self._slot_lock:
            if self._last_slot == slot:
                self._last_slot = slot - 1

    # -- per-slot entry ----------------------------------------------------

    def on_slot_tick(self, current_slot: int, processor=None):
        """Once per slot: run (or queue) the pre-advance toward
        `current_slot + 1`.

        With a `processor`, the advance is submitted on the low-priority
        STATE_ADVANCE lane and this returns immediately; a refused submit
        (backpressure/shutdown race) UNCLAIMS the slot so the next tick
        retries — the epoch transition never runs inline on the
        heartbeat/slot-tick thread. Without a processor, the advance runs
        inline (tests and timer-only nodes)."""
        if not self._claim_slot(int(current_slot)):
            return
        if processor is not None:
            from ..beacon_processor import WorkType

            if not processor.submit(
                WorkType.STATE_ADVANCE, int(current_slot), self._advance
            ):
                self._unclaim_slot(int(current_slot))
            return
        self._advance(int(current_slot))

    def _advance(self, current_slot: int):
        with self._run_lock:
            self._advance_locked(current_slot)

    def _advance_locked(self, current_slot: int):
        next_slot = current_slot + 1
        chain = self.chain
        head_root = chain.head_root
        head_state = chain.head_state
        if head_state.slot >= next_slot:
            return  # head already at/past the target
        if head_state.slot < current_slot:
            # head is stale — this slot's block is likely still in flight
            # (no local proposer), so a pre-advance keyed off the old head
            # could never be consumed; skip instead of burning an epoch
            # transition that no import will use
            return
        with start_timer("state_advance_seconds"):
            state = head_state.copy()
            while state.slot < next_slot:
                per_slot_processing(state, chain.spec, chain.E)
            # Build the tree-hash cache here, off the hot path (the
            # reference's state_advance_timer.rs builds caches for the
            # same reason): an epoch transition dirties every balance
            # leaf, and without this the proposer's post-state root pays
            # the full-registry rehash — ~500 ms at 1M validators —
            # inside the assemble stage. The CoW hand-outs share the
            # cache, so production re-hashes only the block's own edits.
            state.hash_tree_root()
        if chain.head_root != head_root:
            # head moved while we were advancing: the snapshot is keyed
            # off a dead head and could never be consumed — discard it
            # instead of evicting the (possibly useful) current entry
            inc_counter("state_advance_wasted_total")
            log.info(
                "discarding stale pre-advance",
                head=head_root.hex()[:12],
                to_slot=next_slot,
            )
            return
        chain.state_advance_cache.put(head_root, next_slot, state)
        log.info(
            "pre-advanced head state",
            head=head_root.hex()[:12],
            to_slot=next_slot,
        )
