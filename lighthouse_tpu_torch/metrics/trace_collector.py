"""Bounded collector of completed trace trees.

The reference threads `tracing` spans with parentage through every
subsystem and ships them to subscribers; this is that capability sized to
the node: `utils/tracing` delivers every COMPLETED root span (children
attached on close, across `copy_context` thread hops) here, and the
collector keeps

  * a ring of the most recent traces (debugging "what just happened"),
  * a slowest-K reservoir per root name (block_import, epoch_transition,
    attestation_batch, sync_range_batch, api_request, ...) so the tail
    latencies that matter survive ring churn,
  * per-stage SELF-time rollups (a span's duration minus its children's),

and exports any held trace as Chrome trace-event JSON (`chrome://tracing`
/ Perfetto "traceEvents" format), served at `/lighthouse/traces` and
`/lighthouse/traces/<id>` by both the MetricsServer and the Beacon API.

Knobs: `LIGHTHOUSE_TPU_TRACE_RING` (ring size, default 256),
`LIGHTHOUSE_TPU_TRACE_SLOWEST_K` (reservoir depth per root, default 8),
`LIGHTHOUSE_TPU_TRACE_COLLECT=0` (checked by utils/tracing: spans revert
to the flat per-name histograms and nothing is delivered here)."""

from __future__ import annotations

import heapq
import os
import threading
from collections import deque

from . import REGISTRY

#: the root-span taxonomy of the hot paths (OBSERVABILITY.md) — counters
#: for these are eagerly registered; other root names fold into "other"
#: to bound series cardinality
ROOT_SPAN_NAMES = (
    "block_import",
    "epoch_transition",
    "attestation_batch",
    "sync_range_batch",
    "api_request",
    "fork_choice_get_head",
    "slasher_process",
    "da_verify",
    "block_production",
    "vc_duty_cycle",
)

_RING_SIZE = int(os.environ.get("LIGHTHOUSE_TPU_TRACE_RING", "256"))
_SLOWEST_K = int(os.environ.get("LIGHTHOUSE_TPU_TRACE_SLOWEST_K", "8"))
#: cap on DISTINCT root names holding reservoirs (a dynamic root name —
#: itself a metric-hygiene lint violation — must not grow memory forever)
_MAX_RESERVOIR_ROOTS = 32

_TRACES_TOTAL = REGISTRY.counter(
    "trace_collector_traces_total",
    "completed trace trees delivered to the collector, by root span name",
)
for _name in ROOT_SPAN_NAMES:
    _TRACES_TOTAL.inc(0, root=_name)
_TRACES_TOTAL.inc(0, root="other")
REGISTRY.gauge(
    "trace_collector_ring_size", "traces currently held in the recent ring"
).set(0)


def _walk(span):
    """Yield every span of a tree (snapshot the child lists: late spans
    from worker threads may still be attaching while we walk)."""
    stack = [span]
    while stack:
        s = stack.pop()
        yield s
        stack.extend(list(s.children))


def span_count(root) -> int:
    return sum(1 for _ in _walk(root))


def self_time_s(span) -> float:
    """A span's duration minus its (closed) children's durations — the
    time attributable to the stage itself."""
    dur = span.duration_s or 0.0
    child = sum((c.duration_s or 0.0) for c in list(span.children))
    return max(0.0, dur - child)


def stage_rollup(root) -> dict:
    """Per-stage self-time totals for one trace: name -> {self_ms, count}.
    The rollup is what the bench breakdowns and the index endpoint show —
    stages overlap when nested, so self-time (not duration) is what sums
    to the root."""
    out: dict[str, dict] = {}
    for s in _walk(root):
        e = out.setdefault(s.name, {"self_ms": 0.0, "count": 0})
        e["self_ms"] += self_time_s(s) * 1000.0
        e["count"] += 1
    for e in out.values():
        e["self_ms"] = round(e["self_ms"], 3)
    return out


def to_chrome_trace(root) -> dict:
    """One trace tree as Chrome trace-event JSON ("traceEvents" complete
    events, ph="X"): ts/dur in microseconds relative to the root's start,
    user span fields under args. Loadable in chrome://tracing / Perfetto."""
    t0 = root.t0
    events = []
    for s in _walk(root):
        args = {k: repr(v) if isinstance(v, bytes) else v
                for k, v in s.fields.items()}
        args["self_time_ms"] = round(self_time_s(s) * 1000.0, 3)
        events.append(
            {
                "name": s.name,
                "cat": "span",
                "ph": "X",
                "ts": round((s.t0 - t0) * 1e6, 1),
                "dur": round((s.duration_s or 0.0) * 1e6, 1),
                "pid": 0,
                "tid": s.tid,
                "args": args,
            }
        )
    events.sort(key=lambda e: e["ts"])
    return {
        "displayTimeUnit": "ms",
        "otherData": {"trace_id": root.trace_id, "root": root.name},
        "traceEvents": events,
    }


def trace_summary(root) -> dict:
    return {
        "trace_id": root.trace_id,
        "root": root.name,
        "duration_ms": round((root.duration_s or 0.0) * 1000.0, 3),
        "spans": span_count(root),
        "stages": stage_rollup(root),
    }


class TraceCollector:
    def __init__(self, ring_size: int = _RING_SIZE, slowest_k: int = _SLOWEST_K):
        self._slowest_k = max(1, slowest_k)
        self._ring: deque = deque(maxlen=max(1, ring_size))
        #: root name -> min-heap of (duration_s, seq, root span)
        self._slowest: dict[str, list] = {}
        self._by_id: dict[str, object] = {}
        self._seq = 0
        self._lock = threading.Lock()

    # -- ingest ----------------------------------------------------------

    def record(self, root):
        """Deliver one completed root span (called by Span.__exit__)."""
        label = root.name if root.name in ROOT_SPAN_NAMES else "other"
        _TRACES_TOTAL.inc(root=label)
        with self._lock:
            self._seq += 1
            if len(self._ring) == self._ring.maxlen:
                evicted = self._ring[0]
                self._drop_from_index_if_unreferenced(evicted, skip_ring_head=True)
            self._ring.append(root)
            self._by_id[root.trace_id] = root
            heap = self._slowest.get(root.name)
            if heap is None:
                if len(self._slowest) >= _MAX_RESERVOIR_ROOTS:
                    heap = None  # unknown-root overflow: ring-only retention
                else:
                    heap = self._slowest.setdefault(root.name, [])
            if heap is not None:
                entry = (root.duration_s or 0.0, self._seq, root)
                if len(heap) < self._slowest_k:
                    heapq.heappush(heap, entry)
                elif entry[0] > heap[0][0]:
                    _, _, popped = heapq.heapreplace(heap, entry)
                    self._drop_from_index_if_unreferenced(popped)
            REGISTRY.gauge("trace_collector_ring_size").set(len(self._ring))

    def _drop_from_index_if_unreferenced(self, root, skip_ring_head=False):
        """Forget an evicted trace's id unless the other structure still
        holds it (call under the lock)."""
        ring = self._ring
        in_ring = any(
            r is root
            for i, r in enumerate(ring)
            if not (skip_ring_head and i == 0)
        )
        in_reservoir = any(
            any(e[2] is root for e in heap) for heap in self._slowest.values()
        )
        if not in_ring and not in_reservoir:
            self._by_id.pop(root.trace_id, None)

    # -- queries ---------------------------------------------------------

    def get(self, trace_id: str):
        with self._lock:
            return self._by_id.get(trace_id)

    def recent(self, limit: int = 50) -> list:
        with self._lock:
            return list(self._ring)[-limit:][::-1]

    def slowest(self, root_name: str) -> list:
        """Slowest retained traces for a root name, slowest first."""
        with self._lock:
            heap = self._slowest.get(root_name, [])
            return [e[2] for e in sorted(heap, reverse=True)]

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._slowest.clear()
            self._by_id.clear()
            REGISTRY.gauge("trace_collector_ring_size").set(0)

    # -- HTTP bodies (shared by MetricsServer and http_api) ---------------

    def index_json(self, limit: int = 50) -> dict:
        with self._lock:
            recent = list(self._ring)[-limit:][::-1]
            slowest = {
                name: [e[2] for e in sorted(heap, reverse=True)]
                for name, heap in self._slowest.items()
            }
        return {
            "data": {
                "recent": [trace_summary(r) for r in recent],
                "slowest": {
                    name: [trace_summary(r) for r in roots]
                    for name, roots in slowest.items()
                },
            }
        }

    def chrome_json(self, trace_id: str) -> dict | None:
        root = self.get(trace_id)
        if root is None:
            return None
        return to_chrome_trace(root)


#: process-global collector (the lazy_static analog, like REGISTRY)
COLLECTOR = TraceCollector()
