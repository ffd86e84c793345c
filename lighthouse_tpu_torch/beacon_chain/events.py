"""Server-sent event streams for API consumers.

The beacon_chain/src/events.rs analog: a `ServerSentEventHandler` with one
broadcast channel per event topic (block, head, finalized_checkpoint,
chain_reorg, attestation); the chain pushes, any number of subscribers
drain bounded per-subscriber queues (slow consumers drop oldest — the
reference's broadcast channel lags the same way). The http_api /events
route renders these as SSE frames.

Fan-out is a real broadcast tier: the chain's publishing thread only
enqueues onto one bounded broadcast queue; a dedicated thread (the gossip
relay-thread pattern) serializes each event ONCE and offers the shared
frame to every subscriber queue, dropping (counted) rather than blocking
on slow consumers and evicting any subscriber that lags persistently.
Synchronous listeners (response-cache invalidation) still run inline on
the publishing thread — their ordering guarantee is what keeps a cached
body from outliving the head it was built at."""

from __future__ import annotations

import json
import queue
import threading
import time

from ..metrics import REGISTRY

TOPIC_BLOCK = "block"
TOPIC_HEAD = "head"
TOPIC_FINALIZED = "finalized_checkpoint"
TOPIC_REORG = "chain_reorg"
TOPIC_ATTESTATION = "attestation"

ALL_TOPICS = (
    TOPIC_BLOCK,
    TOPIC_HEAD,
    TOPIC_FINALIZED,
    TOPIC_REORG,
    TOPIC_ATTESTATION,
)

_QUEUE_CAP = 256
#: broadcast staging queue between publishing threads and the fan-out
#: thread; overflow here means the fan-out thread itself cannot keep up
#: with the chain's event rate (counted, never blocks the chain)
_BROADCAST_CAP = 4096
#: consecutive displaced offers before a subscriber is evicted — at head
#: cadence this is minutes of a consumer not draining at all
_EVICT_AFTER = 64

_SUBSCRIBERS = REGISTRY.gauge(
    "sse_subscribers", "live SSE subscriptions across all handlers"
)
_SUBSCRIBERS.set(0)
_DELIVERED = REGISTRY.counter(
    "sse_events_delivered_total", "records enqueued onto subscriber queues"
)
_DELIVERED.inc(0)
_SERIALIZED = REGISTRY.counter(
    "sse_events_serialized_total", "events rendered to SSE frame bytes (once per event)"
)
_SERIALIZED.inc(0)
_DROPPED = REGISTRY.counter(
    "sse_dropped_total", "events lost per cause (slow_consumer/evicted/publish_overflow)"
)
for _reason in ("slow_consumer", "evicted", "publish_overflow"):
    _DROPPED.inc(0, reason=_reason)

# the subscriber gauge is process-global while handlers are per-chain
# (testnets run many chains in one process), so the count aggregates here
_SUB_TOTAL_LOCK = threading.Lock()
_sub_total = 0


def _subs_changed(delta: int):
    global _sub_total
    with _SUB_TOTAL_LOCK:
        _sub_total += delta
        _SUBSCRIBERS.set(_sub_total)


def sse_frame(ev: dict) -> str:
    """One event as an SSE wire frame — the single definition of the
    format (shared by subscriptions and the http_api /events route)."""
    return f"event: {ev['topic']}\ndata: {json.dumps(ev['data'])}\n\n"


def _frame_bytes(ev: dict) -> bytes:
    """Serialize one event to SSE wire bytes — called exactly once per
    published event by the broadcast thread; every subscriber shares the
    returned buffer."""
    _SERIALIZED.inc()
    return sse_frame(ev).encode()


class EventSubscription:
    """One consumer's bounded queue over a set of topics.

    The broadcast thread enqueues records of (event dict, shared SSE
    frame bytes, publish monotonic time). poll()/drain() keep the
    historical dict shape; poll_record()/poll_frame() expose the shared
    frame so streaming consumers never re-serialize."""

    def __init__(self, topics):
        self.topics = frozenset(topics)
        #: set when the handler dropped this subscription (unsubscribe or
        #: slow-consumer eviction); producers stop offering, consumers
        #: should stop polling
        self.closed = False
        self.evicted = False
        self._lag = 0  # consecutive displaced offers (broadcast thread only)
        self._q: queue.Queue = queue.Queue(maxsize=_QUEUE_CAP)

    def _offer(self, rec) -> bool:
        """Enqueue one record (broadcast thread only). Returns True when
        the queue was full and the oldest record was displaced."""
        try:
            self._q.put_nowait(rec)
            return False
        except queue.Full:
            # lagging consumer: drop the oldest, keep the stream moving
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            try:
                self._q.put_nowait(rec)
            except queue.Full:
                pass
            return True

    def poll_record(self, timeout: float = 0.0):
        """(event dict, frame bytes, publish monotonic time) or None."""
        try:
            return self._q.get(timeout=timeout) if timeout else self._q.get_nowait()
        except queue.Empty:
            return None

    def poll(self, timeout: float = 0.0) -> dict | None:
        rec = self.poll_record(timeout=timeout)
        return None if rec is None else rec[0]

    def poll_frame(self, timeout: float = 0.0) -> bytes | None:
        rec = self.poll_record(timeout=timeout)
        return None if rec is None else rec[1]

    def drain(self) -> list[dict]:
        out = []
        while True:
            ev = self.poll()
            if ev is None:
                return out
            out.append(ev)

    def sse_frames(self, timeout: float = 0.0) -> str:
        """Render pending events as SSE wire frames; with a timeout, block
        up to that long for the first event."""
        out = []
        if timeout:
            f = self.poll_frame(timeout=timeout)
            if f is not None:
                out.append(f)
        while True:
            f = self.poll_frame()
            if f is None:
                break
            out.append(f)
        return b"".join(out).decode()


class ServerSentEventHandler:
    def __init__(self):
        self._subs: list[EventSubscription] = []
        # in-process synchronous consumers (the http_api response cache's
        # head-change invalidation, the /headers block-listing eviction):
        # unlike subscriptions there is no queue to poll — the chain's
        # publishing thread calls them inline, so they must be cheap
        self._listeners: list[tuple[frozenset, object]] = []
        self._lock = threading.Lock()
        # broadcast tier: publishers stage (event, t_pub) here; the
        # fan-out thread (started lazily on first subscribe so idle
        # chains never own a thread) serializes once and distributes
        self._bq: queue.Queue = queue.Queue(maxsize=_BROADCAST_CAP)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # flush() accounting: events staged vs events fully fanned out
        self._cond = threading.Condition()
        self._published_seq = 0
        self._delivered_seq = 0

    def _ensure_thread_locked(self):
        if self._thread is not None and self._thread.is_alive():
            return
        # re-arm after close(): the old thread (if any) still holds the
        # old stop event, so it winds down without racing the new one
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._broadcast_loop, daemon=True, name="sse_broadcast"
        )
        self._thread.start()

    def subscribe(self, topics=ALL_TOPICS) -> EventSubscription:
        bad = set(topics) - set(ALL_TOPICS)
        if bad:
            raise ValueError(f"unknown event topics: {sorted(bad)}")
        sub = EventSubscription(topics)
        with self._lock:
            self._subs.append(sub)
            self._ensure_thread_locked()
        _subs_changed(+1)
        return sub

    def unsubscribe(self, sub: EventSubscription):
        with self._lock:
            if sub not in self._subs:
                sub.closed = True  # already evicted: gauge was adjusted then
                return
            self._subs.remove(sub)
        sub.closed = True
        _subs_changed(-1)

    def add_listener(self, topics, fn):
        """Register a synchronous in-process listener `fn(topic, data)`
        for a set of topics. Listener faults are contained (logged, never
        propagated into the chain's import path)."""
        bad = set(topics) - set(ALL_TOPICS)
        if bad:
            raise ValueError(f"unknown event topics: {sorted(bad)}")
        with self._lock:
            self._listeners.append((frozenset(topics), fn))

    def remove_listener(self, fn):
        # equality, not identity: every `self.method` access mints a new
        # bound-method object, but equal ones compare ==
        with self._lock:
            self._listeners = [
                (t, f) for (t, f) in self._listeners if f != fn
            ]

    def _publish(self, topic: str, data: dict):
        ev = {"topic": topic, "data": data}
        with self._lock:
            listeners = list(self._listeners)
            fan = bool(self._subs)
        if fan:
            with self._cond:
                self._published_seq += 1
            try:
                self._bq.put_nowait((ev, time.monotonic()))
            except queue.Full:
                # never block the chain's publishing thread on fan-out
                _DROPPED.inc(reason="publish_overflow")
                with self._cond:
                    self._delivered_seq += 1  # keep flush() accounting closed
                    self._cond.notify_all()
        for topics, fn in listeners:
            if topic in topics:
                try:
                    fn(topic, data)
                except Exception:  # noqa: BLE001 — listener faults stay local
                    from ..utils.logging import get_logger

                    get_logger("lighthouse_tpu_torch.events").exception(
                        "event listener failed (topic=%s)", topic
                    )

    def _broadcast_loop(self):
        stop = self._stop
        while True:
            try:
                item = self._bq.get(timeout=0.2)
            except queue.Empty:
                if stop.is_set():
                    return
                continue
            if item is None:
                return
            ev, t_pub = item
            topic = ev["topic"]
            rec = (ev, _frame_bytes(ev), t_pub)
            with self._lock:
                subs = list(self._subs)
            delivered = 0
            laggards = []
            for s in subs:
                if topic not in s.topics:
                    continue
                delivered += 1  # the record landed even when it displaced
                if s._offer(rec):
                    _DROPPED.inc(reason="slow_consumer")
                    s._lag += 1
                    if s._lag >= _EVICT_AFTER:
                        laggards.append(s)
                else:
                    s._lag = 0
            if delivered:
                _DELIVERED.inc(delivered)
            if laggards:
                evicted = []
                with self._lock:
                    for s in laggards:
                        if s in self._subs:
                            self._subs.remove(s)
                            s.closed = True
                            s.evicted = True
                            evicted.append(s)
                for s in evicted:
                    _DROPPED.inc(reason="evicted")
                if evicted:
                    _subs_changed(-len(evicted))
            with self._cond:
                self._delivered_seq += 1
                self._cond.notify_all()

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every event published so far has been fanned out to
        subscriber queues (or the timeout lapses). Delivery is async —
        tests and benches use this as their happens-before edge."""
        deadline = time.monotonic() + timeout
        with self._cond:
            target = self._published_seq
            while self._delivered_seq < target:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
        return True

    def close(self, timeout: float = 2.0):
        """Stop the broadcast thread (pending events drain first). A later
        subscribe() re-arms a fresh thread."""
        self._stop.set()
        try:
            self._bq.put_nowait(None)
        except queue.Full:
            pass
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._thread = None

    def reinit_after_fork(self):
        """Called in a freshly forked serving worker (http_api.workers):
        the child inherits this handler as a CoW snapshot — possibly with
        a held lock, and with subscriber queues whose consumers exist only
        in the parent. Fresh synchronization, no subscribers, no broadcast
        thread. LISTENERS are kept: the worker republishes fanned parent
        events through _publish to drive its own cache invalidation."""
        self._lock = threading.Lock()
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread = None
        self._subs = []
        self._bq = queue.Queue(maxsize=_BROADCAST_CAP)
        self._published_seq = 0
        self._delivered_seq = 0

    # -- chain-facing emitters (events.rs register_* methods) -----------

    def register_block(self, block_root: bytes, slot: int):
        self._publish(
            TOPIC_BLOCK,
            {"slot": str(slot), "block": "0x" + block_root.hex()},
        )

    def register_head(self, head_root: bytes, slot: int, state_root: bytes):
        self._publish(
            TOPIC_HEAD,
            {
                "slot": str(slot),
                "block": "0x" + head_root.hex(),
                "state": "0x" + state_root.hex(),
            },
        )

    def register_finalized(self, checkpoint):
        self._publish(
            TOPIC_FINALIZED,
            {
                "epoch": str(checkpoint.epoch),
                "block": "0x" + bytes(checkpoint.root).hex(),
            },
        )

    def register_reorg(self, old_head: bytes, new_head: bytes, slot: int, depth: int):
        self._publish(
            TOPIC_REORG,
            {
                "slot": str(slot),
                "depth": str(depth),
                "old_head_block": "0x" + old_head.hex(),
                "new_head_block": "0x" + new_head.hex(),
            },
        )

    def register_attestation(self, attestation):
        d = attestation.data
        self._publish(
            TOPIC_ATTESTATION,
            {
                "slot": str(d.slot),
                "index": str(d.index),
                "beacon_block_root": "0x" + bytes(d.beacon_block_root).hex(),
            },
        )
