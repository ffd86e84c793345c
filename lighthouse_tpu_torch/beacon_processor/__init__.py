"""BeaconProcessor: the priority work-queue scheduler.

Mirrors beacon_node/beacon_processor/src/lib.rs:1-39,96-130: a manager
drains bounded per-kind queues in strict priority order onto a small worker
pool; gossip attestations and aggregates are coalesced into batches of up
to 64 (`:200-201,553-576`) so signature verification amortizes into one
RLC batch — on this stack that batch is exactly what the device BLS kernel
wants. A re-processing queue holds early/unknown-parent work for retry
(work_reprocessing_queue.rs).

The reference schedules tokio blocking tasks; here a thread pool plays that
role — device work is batched, not threaded, so workers mostly marshal
batches into the chain's batch entry points.
"""

from __future__ import annotations

import contextvars
import enum
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..metrics import REGISTRY, inc_counter, set_gauge
from ..utils.tracing import adopt_thread_span, current_span

MAX_GOSSIP_ATTESTATION_BATCH_SIZE = 64
MAX_GOSSIP_AGGREGATE_BATCH_SIZE = 64


class WorkType(enum.IntEnum):
    """Queue kinds, priority order (low value = drained first) — the Work
    enum's ~32 variants collapse to the kinds this node implements. Every
    gossip kind has its own lane (the event-driven-node refactor): blocks
    and sidecars outrank aggregates, which outrank raw attestations, which
    outrank the pool-feeding operation topics — so a gossip storm degrades
    the cheap lanes first while block import keeps draining."""

    CHAIN_SEGMENT = 0
    #: lookup-recovered blocks (Work::RpcBlock): ahead of gossip blocks —
    #: a recovered parent chain unblocks held gossip work
    RPC_BLOCK = 1
    GOSSIP_BLOCK = 2
    GOSSIP_BLOB_SIDECAR = 3
    #: PeerDAS column sidecars rank with blob sidecars: both feed the DA
    #: gate that unblocks held block imports
    GOSSIP_DATA_COLUMN_SIDECAR = 4
    GOSSIP_AGGREGATE = 5
    GOSSIP_ATTESTATION = 6
    UNKNOWN_BLOCK_ATTESTATION = 7
    UNKNOWN_BLOCK_AGGREGATE = 8
    GOSSIP_SYNC_COMMITTEE = 9
    API_REQUEST = 10
    GOSSIP_VOLUNTARY_EXIT = 11
    GOSSIP_PROPOSER_SLASHING = 12
    GOSSIP_ATTESTER_SLASHING = 13
    BACKFILL_SYNC = 14
    #: next-slot state pre-advance (beacon_chain/state_advance): pure
    #: speculation — it only saves latency if it finishes before the next
    #: proposal, so it ranks below every protocol lane but above the
    #: slasher (a missed pre-advance costs the proposer an epoch
    #: transition; a deferred slasher cycle costs nothing time-critical)
    STATE_ADVANCE = 15
    #: slasher epoch detection (slasher/service): the whole cycle is
    #: deferrable background work — lowest priority, so a storm drains
    #: every protocol lane before detection takes a worker, and detection
    #: NEVER runs inline on a gossip reader thread (queue-discipline)
    SLASHER_PROCESS = 16
    #: finality migration + store pruning (store/migrator): hot→cold
    #: block moves, restore-point snapshots, DA-window pruning. Like the
    #: slasher it is pure background hygiene — nothing protocol-critical
    #: waits on it, so it drains dead last (migrate.rs's dedicated
    #: migrator thread maps to the lowest lane here)
    MIGRATE_STORE = 17


_QUEUE_BOUNDS = {
    WorkType.CHAIN_SEGMENT: 64,
    WorkType.RPC_BLOCK: 64,
    WorkType.GOSSIP_BLOCK: 1024,
    WorkType.GOSSIP_BLOB_SIDECAR: 1024,
    WorkType.GOSSIP_DATA_COLUMN_SIDECAR: 1024,
    WorkType.GOSSIP_AGGREGATE: 4096,
    WorkType.GOSSIP_ATTESTATION: 16384,
    WorkType.UNKNOWN_BLOCK_ATTESTATION: 8192,
    WorkType.UNKNOWN_BLOCK_AGGREGATE: 4096,
    WorkType.GOSSIP_SYNC_COMMITTEE: 4096,
    WorkType.API_REQUEST: 1024,
    WorkType.GOSSIP_VOLUNTARY_EXIT: 1024,
    WorkType.GOSSIP_PROPOSER_SLASHING: 512,
    WorkType.GOSSIP_ATTESTER_SLASHING: 512,
    WorkType.BACKFILL_SYNC: 64,
    # one advance per slot, stale entries are useless — a tiny bound
    # turns a stalled worker pool into drop-counted backpressure that
    # the timer's slot-unclaim retries next tick
    WorkType.STATE_ADVANCE: 2,
    # one epoch tick per slot; a tiny bound surfaces a stalled worker
    # pool as drop-counted backpressure instead of a silent backlog
    WorkType.SLASHER_PROCESS: 4,
    # one migration per finalized epoch; the per-epoch claim already
    # deduplicates, the bound only backstops a stalled pool
    WorkType.MIGRATE_STORE: 2,
}

_BATCHED = {
    WorkType.GOSSIP_ATTESTATION: MAX_GOSSIP_ATTESTATION_BATCH_SIZE,
    WorkType.GOSSIP_AGGREGATE: MAX_GOSSIP_AGGREGATE_BATCH_SIZE,
}
#: kinds whose handlers receive list[item] (public: the gossip router
#: picks its runner shape off this)
BATCHED_WORK_TYPES = frozenset(_BATCHED)

# Queue observability (the reference's beacon_processor_* metric family):
# time-in-queue and handler-run histograms per WorkType, eagerly
# registered so the series exist at zero for bench/dashboard consumers.
# Queue waits reach seconds under backpressure; the run histograms keep
# the default sub-second buckets.
_QUEUE_WAIT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0,
)
_QUEUE_WAIT = {
    t: REGISTRY.histogram(
        # registered eagerly at import (not a runtime-dynamic name):
        # lint: allow(metric-hygiene) -- bounded by the WorkType enum
        f"beacon_processor_queue_wait_seconds_{t.name.lower()}",
        f"time from submit to worker pickup: {t.name.lower()}",
        buckets=_QUEUE_WAIT_BUCKETS,
    )
    for t in WorkType
}
_HANDLER_RUN = {
    t: REGISTRY.histogram(
        # lint: allow(metric-hygiene) -- bounded by the WorkType enum
        f"beacon_processor_work_seconds_{t.name.lower()}",
        f"handler wall time per drained batch: {t.name.lower()}",
    )
    for t in WorkType
}
for _t in WorkType:
    # distinct name from the unlabelled total: mixing labelled and
    # unlabelled series under one gauge would double-count on sum()
    set_gauge("beacon_processor_queue_depth_by_kind", 0, kind=_t.name.lower())
set_gauge("beacon_processor_queue_depth", 0)
set_gauge("beacon_processor_workers_busy", 0)
set_gauge("beacon_processor_workers_total", 0)
_BUSY_SECONDS = REGISTRY.counter(
    "beacon_processor_busy_seconds_total",
    "cumulative worker-busy wall time; ratio = rate(busy_seconds) / workers",
)
_BUSY_SECONDS.inc(0)
# shutdown accounting: queued work explicitly abandoned (not silently
# dropped) when the processor stops before draining
_ABANDONED = REGISTRY.counter(
    "beacon_processor_abandoned_total",
    "work events abandoned in-queue at shutdown, by kind",
)
for _t in WorkType:
    _ABANDONED.inc(0, kind=_t.name.lower())
# ReprocessQueue observability (work_reprocessing_queue.rs metric family):
# held = entries parked, drained = entries re-submitted (block arrived /
# slot started), expired = entries dropped (slot expiry, caps, shutdown)
_REPROCESS_HELD = REGISTRY.counter(
    "reprocess_held_total", "work events parked in the reprocess queue"
)
_REPROCESS_HELD.inc(0)
_REPROCESS_DRAINED = REGISTRY.counter(
    "reprocess_drained_total",
    "held work events re-submitted to the processor",
)
_REPROCESS_DRAINED.inc(0)
_REPROCESS_EXPIRED = REGISTRY.counter(
    "reprocess_expired_total",
    "held work events dropped without re-firing, by reason",
)
for _reason in ("slot", "root_cap", "total_cap", "shutdown"):
    _REPROCESS_EXPIRED.inc(0, reason=_reason)
set_gauge("reprocess_queue_depth", 0)


def _run_in_ctx(ctx, handler, arg):
    """Run a handler inside the submitter's copied contextvars Context so
    tracing parentage survives the manager→worker thread hop. Each
    WorkEvent carries its own copy, so a Context is never entered twice;
    hand-built events (ctx=None) run in the worker's own context."""
    if ctx is None:
        return handler(arg)
    return ctx.run(_run_adopted, handler, arg)


def _run_adopted(handler, arg):
    """Inside the submitter's context on the worker thread: adopt the
    submitting span in the profiler's thread→span registry for the whole
    handler run, so worker stack samples taken between (or outside) the
    handler's own spans still land under the submitting trace root —
    block_import / sync_range_batch — instead of "unattributed"."""
    with adopt_thread_span(current_span()):
        return handler(arg)


@dataclass
class WorkEvent:
    work_type: WorkType
    item: object
    # handler(item) for singletons; batch handler receives list[item] when
    # the kind is batched.
    handler: object = None
    #: stamped by submit(): monotonic enqueue time (0.0 = hand-built event
    #: that never rode the queue — the wait histogram skips it)
    submitted_at: float = 0.0
    #: the submitter's copied contextvars Context: workers run the handler
    #: inside it so tracing parentage survives the thread hop
    ctx: object = None


@dataclass
class _Queues:
    by_type: dict = field(default_factory=lambda: {t: deque() for t in WorkType})

    def push(self, ev: WorkEvent) -> bool:
        q = self.by_type[ev.work_type]
        if len(q) >= _QUEUE_BOUNDS[ev.work_type]:
            return False
        q.append(ev)
        return True

    def pop_next(self):
        """Highest-priority work: one event, or a coalesced batch for the
        batched kinds (lib.rs:553-576)."""
        for t in WorkType:
            q = self.by_type[t]
            if not q:
                continue
            limit = _BATCHED.get(t)
            if limit is None:
                return t, [q.popleft()]
            batch = []
            while q and len(batch) < limit:
                batch.append(q.popleft())
            return t, batch
        return None, []

    def __len__(self):
        return sum(len(q) for q in self.by_type.values())


class BeaconProcessor:
    def __init__(self, num_workers: int = 2, name: str = "beacon_processor"):
        self._queues = _Queues()
        self._cv = threading.Condition()
        self._work = queue.Queue()  # manager → workers
        self._shutdown = False
        self._idle_workers = num_workers
        self._busy = 0
        set_gauge("beacon_processor_workers_total", num_workers)
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True, name=f"{name}-w{i}")
            for i in range(num_workers)
        ]
        self._manager = threading.Thread(
            target=self._manager_loop, daemon=True, name=f"{name}-mgr"
        )
        self._inflight = 0
        self._done_cv = threading.Condition()
        for w in self._workers:
            w.start()
        self._manager.start()

    # -- producer side -------------------------------------------------------

    def submit(self, work_type: WorkType, item, handler) -> bool:
        """Enqueue work; False (and a drop metric) when the queue is full —
        the reference's backpressure behavior. Each event is stamped with
        its enqueue time (→ the per-kind time-in-queue histogram) and the
        submitter's copied contextvars Context, so worker-side tracing
        spans attach under whatever span submitted the work."""
        ev = WorkEvent(work_type, item, handler)
        with self._cv:
            # a post-shutdown submit (a joining-but-still-live slot tick
            # or sync loop racing stop()) must refuse: the manager is
            # gone, so a push would sit uncounted forever — refusal rides
            # the same drop counter as backpressure
            ok = False if self._shutdown else self._queues.push(ev)
            if ok:
                # stamped only AFTER a successful push — a dropped event
                # under backpressure must not pay the context copy — but
                # still under the cv (the manager pops under it too), so
                # a popped event is always fully stamped
                ev.submitted_at = time.monotonic()
                ev.ctx = contextvars.copy_context()
                kind_depth = len(self._queues.by_type[work_type])
                self._cv.notify()
        if ok:
            set_gauge(
                "beacon_processor_queue_depth_by_kind",
                kind_depth,
                kind=work_type.name.lower(),
            )
        else:
            inc_counter(
                "beacon_processor_dropped_total", kind=work_type.name.lower()
            )
        return ok

    # -- manager / workers ----------------------------------------------------

    def _manager_loop(self):
        while True:
            with self._cv:
                # pop only for an idle worker (lib.rs hands work out only
                # below max_workers): while every worker is busy the
                # arrivals wait in their lanes, so the next pop coalesces
                # them into one batch and takes the highest priority first
                while (not self._queues.__len__() or not self._idle_workers) and not self._shutdown:
                    self._cv.wait(timeout=0.1)
                if self._shutdown:
                    # shutdown abandons the backlog EXPLICITLY: stop must
                    # not block behind a storm's queued work, and the drop
                    # is counted, never silent (graceful-shutdown audit)
                    abandoned = {
                        t: len(q)
                        for t, q in self._queues.by_type.items()
                        if q
                    }
                    for q in self._queues.by_type.values():
                        q.clear()
                else:
                    abandoned = None
                if abandoned is not None:
                    for t, n in abandoned.items():
                        _ABANDONED.inc(n, kind=t.name.lower())
                    # the depth gauges are process-global (shared
                    # REGISTRY): leaving them frozen at the pre-shutdown
                    # backlog would show a phantom queue for the rest of
                    # the process (benches run many processors serially)
                    for t in WorkType:
                        set_gauge(
                            "beacon_processor_queue_depth_by_kind",
                            0,
                            kind=t.name.lower(),
                        )
                    set_gauge("beacon_processor_queue_depth", 0)
                    break
                t, batch = self._queues.pop_next()
                # only the drained kind's depth changed on this pop (the
                # submitter updates the pushed kind's); read both depths
                # under the cv, publish after it drops so gauge locks stay
                # off the submit path
                kind_depth = len(self._queues.by_type[t])
                total_depth = len(self._queues)
                if batch:
                    self._idle_workers -= 1
                    # inflight marked BEFORE the queue lock drops so drain()
                    # can never observe empty-queues + zero-inflight while a
                    # popped batch is still in the manager's hands
                    with self._done_cv:
                        self._inflight += 1
            set_gauge(
                "beacon_processor_queue_depth_by_kind",
                kind_depth,
                kind=t.name.lower(),
            )
            set_gauge("beacon_processor_queue_depth", total_depth)
            if not batch:
                continue
            self._work.put((t, batch))

    def _worker_loop(self):
        while True:
            got = self._work.get()
            if got is None:
                return
            t, batch = got
            pickup = time.monotonic()
            wait_hist = _QUEUE_WAIT[t]
            for ev in batch:
                if ev.submitted_at > 0.0:
                    wait_hist.observe(pickup - ev.submitted_at)
            with self._done_cv:
                self._busy += 1
                set_gauge("beacon_processor_workers_busy", self._busy)
            try:
                if t in _BATCHED:
                    # events may carry different batch handlers (gossip vs
                    # API paths); group so each handler gets its own items
                    by_handler: dict[int, tuple] = {}
                    for ev in batch:
                        key = id(ev.handler)
                        if key not in by_handler:
                            by_handler[key] = (ev.handler, [], ev.ctx)
                        by_handler[key][1].append(ev.item)
                    for handler, items, ctx in by_handler.values():
                        _run_in_ctx(ctx, handler, items)
                else:
                    for ev in batch:
                        _run_in_ctx(ev.ctx, ev.handler, ev.item)
                inc_counter(
                    "beacon_processor_processed_total",
                    amount=len(batch),
                    kind=t.name.lower(),
                )
            except Exception:
                inc_counter(
                    "beacon_processor_errors_total", kind=t.name.lower()
                )
            finally:
                busy_s = time.monotonic() - pickup
                _HANDLER_RUN[t].observe(busy_s)
                _BUSY_SECONDS.inc(busy_s)
                with self._done_cv:
                    self._busy -= 1
                    set_gauge("beacon_processor_workers_busy", self._busy)
                    self._inflight -= 1
                    self._done_cv.notify_all()
                with self._cv:
                    self._idle_workers += 1
                    self._cv.notify()

    # -- lifecycle -------------------------------------------------------------

    def drain(self, timeout: float = 10.0):
        """Block until every queued item has been processed (test helper)."""
        import time

        deadline = time.monotonic() + timeout
        with self._done_cv:
            while (
                len(self._queues) or self._inflight
            ) and time.monotonic() < deadline:
                self._done_cv.wait(timeout=0.05)
        return not len(self._queues) and not self._inflight

    def shutdown(self):
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        self._manager.join(timeout=2)
        for _ in self._workers:
            self._work.put(None)
        for w in self._workers:
            w.join(timeout=2)


#: held entries per unknown root: one hostile root must not monopolize
#: the queue (work_reprocessing_queue.rs caps per-root attestations)
REPROCESS_PER_ROOT_CAP = 64
#: total held entries across every root + slot bucket
REPROCESS_TOTAL_CAP = 8192
#: slots a held entry survives past its stamped slot before the slot
#: tick expires it (the reference holds queued attestations for roughly
#: one slot; two here — gossip + lookup recovery both get a full chance)
REPROCESS_EXPIRY_SLOTS = 2


class ReprocessQueue:
    """Early/unknown-parent work held for retry (work_reprocessing_queue.rs):
    attestations for unknown blocks re-fire when the block arrives; early
    work re-fires at its slot. BOUNDED: per-root and total caps refuse new
    work when full (counted, like the processor's backpressure), and every
    entry is slot-stamped so the NetworkService's slot tick expires work
    whose block never arrived — held work can no longer leak forever."""

    def __init__(
        self,
        per_root_cap: int = REPROCESS_PER_ROOT_CAP,
        total_cap: int = REPROCESS_TOTAL_CAP,
        expiry_slots: int = REPROCESS_EXPIRY_SLOTS,
    ):
        self.per_root_cap = per_root_cap
        self.total_cap = total_cap
        self.expiry_slots = expiry_slots
        #: root -> [(slot, ev)] — slot is the work's anchoring slot
        #: (attestation slot), None = never slot-expired (caps still apply)
        self._by_block_root: dict[bytes, list[tuple[int | None, WorkEvent]]] = {}
        self._by_slot: dict[int, list[WorkEvent]] = {}
        self._total = 0
        self._lock = threading.Lock()

    def _set_depth(self):
        set_gauge("reprocess_queue_depth", self._total)

    def hold_for_block(
        self, block_root: bytes, ev: WorkEvent, slot: int | None = None
    ) -> bool:
        """Park work until `block_root` imports. False (and an expired
        count) when a cap refuses it — callers treat that as load shed."""
        with self._lock:
            if self._total >= self.total_cap:
                reason = "total_cap"
            else:
                held = self._by_block_root.setdefault(block_root, [])
                if len(held) >= self.per_root_cap:
                    reason = "root_cap"
                else:
                    held.append((slot, ev))
                    self._total += 1
                    _REPROCESS_HELD.inc()
                    self._set_depth()
                    return True
        _REPROCESS_EXPIRED.inc(reason=reason)
        return False

    def hold_for_slot(self, slot: int, ev: WorkEvent) -> bool:
        with self._lock:
            if self._total >= self.total_cap:
                pass
            else:
                self._by_slot.setdefault(slot, []).append(ev)
                self._total += 1
                _REPROCESS_HELD.inc()
                self._set_depth()
                return True
        _REPROCESS_EXPIRED.inc(reason="total_cap")
        return False

    def block_imported(self, block_root: bytes, processor: BeaconProcessor):
        with self._lock:
            entries = self._by_block_root.pop(block_root, [])
            self._total -= len(entries)
            self._set_depth()
        for _slot, ev in entries:
            processor.submit(ev.work_type, ev.item, ev.handler)
        if entries:
            _REPROCESS_DRAINED.inc(len(entries))
        return len(entries)

    def slot_started(self, slot: int, processor: BeaconProcessor):
        with self._lock:
            due = [s for s in self._by_slot if s <= slot]
            evs = [ev for s in due for ev in self._by_slot.pop(s)]
            self._total -= len(evs)
            self._set_depth()
        for ev in evs:
            processor.submit(ev.work_type, ev.item, ev.handler)
        if evs:
            _REPROCESS_DRAINED.inc(len(evs))
        return len(evs)

    def expire(self, current_slot: int) -> int:
        """Drop held-for-block entries whose stamped slot is more than
        `expiry_slots` behind the wall clock — the block they wait on is
        not coming (or arrived under a different root). Driven by the
        NetworkService slot tick."""
        expired = 0
        with self._lock:
            for root in list(self._by_block_root):
                kept = []
                for slot, ev in self._by_block_root[root]:
                    if (
                        slot is not None
                        and slot + self.expiry_slots < current_slot
                    ):
                        expired += 1
                    else:
                        kept.append((slot, ev))
                if kept:
                    self._by_block_root[root] = kept
                else:
                    del self._by_block_root[root]
            self._total -= expired
            self._set_depth()
        if expired:
            _REPROCESS_EXPIRED.inc(expired, reason="slot")
        return expired

    def clear(self, reason: str = "shutdown") -> int:
        """Abandon everything held (NetworkService.stop): counted under
        `reprocess_expired_total{reason=shutdown}`, never silent."""
        with self._lock:
            n = self._total
            self._by_block_root.clear()
            self._by_slot.clear()
            self._total = 0
            self._set_depth()
        if n:
            _REPROCESS_EXPIRED.inc(n, reason=reason)
        return n

    def __len__(self):
        with self._lock:
            return self._total
