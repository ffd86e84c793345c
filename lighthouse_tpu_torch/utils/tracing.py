"""Lightweight tracing spans, assembled into trace trees.

The reference threads `tracing` spans through the node (common/logging
bridges slog+tracing; spans carry timing and parentage). This module is
the same capability sized to this runtime: context-manager spans that

  * record wall time into the metrics registry (one histogram per span
    name: `trace_span_seconds_<name>` — Prometheus-visible),
  * know their parent (contextvars, so they follow the work across
    threads started with `copy_context` — the beacon_processor runs each
    handler inside the submitter's copied context, so worker-side spans
    attach under the submitting span — and stay correct under asyncio),
  * assemble into TREES: every span carries its root's `trace_id`,
    children attach to their parent on close, and a completed ROOT span
    (no parent) is delivered to `metrics.trace_collector.COLLECTOR`
    (recent-ring + slowest-K reservoir, Chrome trace-event export at
    `/lighthouse/traces`),
  * publish themselves in a thread→span registry (`thread_spans()`) on
    enter/exit so the stack profiler (metrics/profiler) can attribute
    another thread's samples to its innermost active span — contextvars
    are not readable cross-thread; `adopt_thread_span` lets the
    beacon_processor register the SUBMITTING span for a worker-side
    handler run,
  * and emit one structured log line per span at close
    (`span=<name> parent=<name> ms=<dur>`), rate-limited per span name
    so hot paths don't flood the log.

`LIGHTHOUSE_TPU_TRACE_COLLECT=0` disables tree assembly and collection
entirely (checked at root-span entry; children inherit the decision):
spans revert to exactly the flat per-name histogram + log behavior.

Usage:
    with span("block_import", root="0x.."):
        ...
    @traced("epoch_transition")
    def process_epoch(...): ...
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import os
import threading
import time

from ..metrics import REGISTRY
from ..metrics.trace_collector import COLLECTOR
from .logging import get_logger

log = get_logger("lighthouse_tpu_torch.trace")

_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "trace_span", default=None
)

# per-span-name log rate limit (seconds); metrics capture every sample
_LOG_EVERY = 5.0
_last_logged: dict[str, float] = {}

_trace_ids = itertools.count(1)

#: thread ident -> innermost ACTIVE span on that thread. The stack
#: profiler (metrics/profiler) samples other threads' stacks and needs to
#: know which span each thread is inside — contextvars are not readable
#: cross-thread, so spans publish themselves here on __enter__/__exit__.
#: Each thread writes only its own key (GIL-atomic dict ops); readers
#: take a snapshot via `thread_spans()`.
_thread_spans: dict[int, "Span"] = {}


def thread_spans() -> dict[int, "Span"]:
    """Snapshot of the thread→innermost-active-span registry."""
    return dict(_thread_spans)


@contextlib.contextmanager
def adopt_thread_span(span_obj: "Span | None"):
    """Attribute this thread's profiler samples to a span that was opened
    on ANOTHER thread for the duration of the block. The beacon_processor
    worker hop needs this: a handler runs inside the submitter's copied
    contextvars Context, so `current_span()` resolves to the submitting
    span (e.g. a `sync_range_batch` root on the sync thread) — adopting
    it makes worker samples land under that trace root instead of
    "unattributed", even between the handler's own spans. Spans the
    handler opens itself nest over (and then restore) the adoption."""
    if span_obj is None:
        yield
        return
    ident = threading.get_ident()
    prev = _thread_spans.get(ident)
    _thread_spans[ident] = span_obj
    try:
        yield
    finally:
        if prev is None:
            _thread_spans.pop(ident, None)
        else:
            _thread_spans[ident] = prev


def _collect_enabled() -> bool:
    return os.environ.get("LIGHTHOUSE_TPU_TRACE_COLLECT", "1") != "0"


class Span:
    __slots__ = (
        "name",
        "fields",
        "parent",
        "children",
        "trace_id",
        "root_name",
        "tid",
        "t0",
        "_token",
        "_thread_prev",
        "_collect",
        "duration_s",
    )

    def __init__(self, name: str, **fields):
        self.name = name
        self.fields = fields
        self.parent: Span | None = None
        self.children: list[Span] = []
        self.trace_id: str | None = None
        self.root_name = name
        self.tid = 0
        self.duration_s: float | None = None
        self.t0 = 0.0
        self._token = None
        self._thread_prev = None
        self._collect = False

    def __enter__(self) -> "Span":
        self.parent = _current.get()
        if self.parent is not None:
            # inherit the root's collect decision and identity — one env
            # read per TRACE, not per span
            self._collect = self.parent._collect
            self.trace_id = self.parent.trace_id
            # root_name is maintained even with collection off: the stack
            # profiler buckets samples by trace root regardless
            self.root_name = self.parent.root_name
        else:
            self._collect = _collect_enabled()
            if self._collect:
                self.trace_id = f"{next(_trace_ids):012x}"
        ident = threading.get_ident()
        self.tid = ident & 0xFFFF
        # publish as this thread's innermost active span (profiler registry)
        self._thread_prev = _thread_spans.get(ident)
        _thread_spans[ident] = self
        self._token = _current.set(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.duration_s = time.perf_counter() - self.t0
        _current.reset(self._token)
        ident = threading.get_ident()
        if self._thread_prev is None:
            _thread_spans.pop(ident, None)
        else:
            _thread_spans[ident] = self._thread_prev
        self._thread_prev = None
        REGISTRY.histogram(
            # hygiene is enforced at span() call sites, not here:
            # lint: allow(metric-hygiene) -- the span machinery itself
            f"trace_span_seconds_{self.name}",
            f"span duration: {self.name}",
        ).observe(self.duration_s)
        if self._collect:
            if self.parent is not None:
                # attach on close: the parent object survives even if it
                # already closed (cross-thread children may finish late —
                # the collector stores the live tree and walks snapshots)
                self.parent.children.append(self)
            else:
                COLLECTOR.record(self)
        now = time.monotonic()
        if now - _last_logged.get(self.name, 0.0) >= _LOG_EVERY:
            _last_logged[self.name] = now
            record = {
                "span": self.name,
                "parent": self.parent.name if self.parent else None,
                "trace": self.trace_id,
                "ms": round(self.duration_s * 1000, 2),
                "error": exc_type.__name__ if exc_type else None,
            }
            # user fields must not collide with the reserved keys above
            # (a TypeError in __exit__ would mask the real exception)
            for k, v in self.fields.items():
                record.setdefault(k, v)
            log.info("span", **record)
        return False  # never swallow


def span(name: str, **fields) -> Span:
    return Span(name, **fields)


def current_span() -> Span | None:
    return _current.get()


def traced(name: str):
    """Decorator form: wraps the function body in a span."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with Span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
