"""SyncService: the autonomous Status-listening catch-up loop.

The last caller-driven piece of the sync engine removed: until now range
sync ran only when something invoked `sync_to_head` — a node that fell
behind (restart, partition, a missed gossip block past the reprocess
window) stayed behind until a caller noticed. This service plays the
sync/manager.rs main-loop role: it watches the peer set's advertised
heads (Status round-trips, the same handshake the engines already use),
measures head lag against the wall clock, and starts/stops range-sync
catch-up by itself —

  * enters range sync when the best advertised (clock-clamped) head is
    more than `head_lag_slots` ahead of ours;
  * backs off exponentially (capped) after a run that made no progress,
    so a stalled peer set is not hammered with Status+range storms;
  * resets the backoff and re-enters immediately when a run progresses
    or when we fall behind again later;
  * shuts down cleanly: `stop()` wakes and JOINS the loop thread.

The loop runs the same `_range_sync` batch state machine callers used to
drive, so every retry/rotation/downscore behavior (and every
`sync_batch_*` metric) is unchanged — only the trigger became
autonomous. Runs are counted in `sync_service_runs_total{result=}` and
the live backoff is exported as `sync_service_backoff_seconds`.
"""

from __future__ import annotations

import threading
import time

from ...metrics import REGISTRY, inc_counter, set_gauge
from ...utils.logging import get_logger

log = get_logger("lighthouse_tpu_torch.sync.service")

# eager registration: dashboards read these before the first run
for _result in ("caught_up", "progress", "failed"):
    REGISTRY.counter(
        "sync_service_runs_total",
        "autonomous range-sync runs, by outcome",
    ).inc(0, result=_result)
for _reason in ("new_serving_peer", "peer_connected"):
    REGISTRY.counter(
        "sync_service_backoff_resets_total",
        "capped-backoff resets outside the normal progress path: a new "
        "serving peer appeared (the backoff was earned against the OLD "
        "peer set — partition heal, eclipse lifted), or a fresh "
        "connection woke the sleeping loop early",
    ).inc(0, reason=_reason)
set_gauge("sync_service_backoff_seconds", 0)


class SyncService:
    def __init__(
        self,
        manager,
        interval: float = 0.5,
        head_lag_slots: int = 2,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 30.0,
        status_poll_interval: float = 5.0,
    ):
        self.manager = manager
        self.service = manager.service
        self.interval = interval
        #: tolerated head lag before catch-up starts: one slot of lag is
        #: ordinary gossip latency, not a reason to open a range sync
        self.head_lag_slots = head_lag_slots
        #: Status refresh cadence while SYNCED. The loop used to Status-
        #: poll every peer every `interval` even at head — a per-tick RPC
        #: storm that drained the server-side Status rate-limit buckets
        #: (keyed by remote HOST on plain TCP, so co-hosted nodes share
        #: one bucket) until even fresh dials' handshakes were refused —
        #: the 10-node partition-heal scenario could never reconnect.
        #: Local head lag is computable for free; only a lagging node
        #: polls eagerly.
        self.status_poll_interval = status_poll_interval
        self._last_status_poll = 0.0
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._consecutive_failures = 0
        self._stop = threading.Event()
        #: set to cut a backoff sleep short (peer connected, stop): a
        #: node that earned a 30 s backoff against a dead peer set must
        #: not serve out that sentence after the partition heals
        self._wake = threading.Event()
        #: serving-peer ids the last tick saw (empty after a tick with no
        #: candidates — so the post-heal tick sees returning peers as NEW)
        self._last_serving_ids: set[str] = set()
        self._thread: threading.Thread | None = None
        #: total catch-up runs attempted (tests read this)
        self.runs = 0

    # -- lifecycle --------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "SyncService":
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop,
            daemon=True,
            name=f"sync-service-{self.service.port}",
        )
        self._thread.start()
        return self

    def on_peer_connected(self):
        """NetworkService reports every fresh peer registration here: the
        loop wakes immediately instead of sleeping out a backoff earned
        against the pre-connection peer set (recovery-time-to-finality
        after a partition heal was previously floored by backoff_max).
        Only wakes that actually cut a backoff count as resets — boot-time
        mesh dials must not drown the regression-sentinel series in
        connection churn."""
        if self.running and not self._wake.is_set():
            if self._consecutive_failures:
                inc_counter(
                    "sync_service_backoff_resets_total", reason="peer_connected"
                )
            self._wake.set()

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                # still draining a range run (it observes service._stopping
                # and the shut-down processor refuses its submits):
                # `running` stays truthful so a restart can't spawn a
                # second loop beside the orphan
                return
        self._thread = None

    # -- the loop ---------------------------------------------------------

    def backoff_s(self) -> float:
        if self._consecutive_failures == 0:
            return 0.0
        return min(
            self.backoff_max_s,
            self.backoff_base_s * (2 ** (self._consecutive_failures - 1)),
        )

    def _loop(self):
        while True:
            self._wake.wait(self.interval + self.backoff_s())
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 — the loop must outlive faults
                log.warning("sync service tick failed", error=str(e)[:200])
                self._consecutive_failures += 1
                inc_counter("sync_service_runs_total", result="failed")
            set_gauge("sync_service_backoff_seconds", self.backoff_s())

    def _tick(self):
        chain = self.service.chain
        # Status polls cost every peer's server a token from a shared
        # bucket: a node at its head has no reason to spend them every
        # tick. Poll eagerly only when LOCALLY behind the wall clock;
        # otherwise refresh peer statuses at `status_poll_interval`.
        local_lag = int(chain.slot_clock.now()) - int(chain.head_state.slot)
        now = time.monotonic()
        if (
            local_lag <= self.head_lag_slots
            and now - self._last_status_poll < self.status_poll_interval
        ):
            return
        self._last_status_poll = now
        # the shared candidate policy (SyncManager.poll_sync_candidates):
        # dead/stale peers drop out; only peers advertising a head past
        # ours serve catch-up batches (flooders at slot 0 would otherwise
        # poison the rotation with empty windows — seen in the storm sim)
        candidates, serving, target = self.manager.poll_sync_candidates()
        # a serving peer we have NOT been failing against voids the
        # accumulated backoff: the failures were earned against the old
        # peer set (all-peers-vanished partitions, eclipse liars), and
        # punishing the healed topology for them stalls recovery
        serving_ids = {p.peer_id for p in serving}
        if self._consecutive_failures and serving_ids - self._last_serving_ids:
            self._consecutive_failures = 0
            inc_counter(
                "sync_service_backoff_resets_total", reason="new_serving_peer"
            )
        self._last_serving_ids = serving_ids
        if not candidates:
            return
        # a Status head_slot is attacker-controlled: clamp to the wall
        # clock before it can size anything (same rule as _range_sync)
        target = min(target, int(chain.slot_clock.now()))
        head_before = int(chain.head_state.slot)
        lag = target - head_before
        if lag <= self.head_lag_slots:
            self._consecutive_failures = 0
            return
        self.runs += 1
        imported = self.manager._range_sync(serving, target)
        caught_up = int(chain.head_state.slot) >= target
        progressed = imported > 0 or int(chain.head_state.slot) > head_before
        if caught_up:
            self._consecutive_failures = 0
            inc_counter("sync_service_runs_total", result="caught_up")
        elif progressed:
            self._consecutive_failures = 0
            inc_counter("sync_service_runs_total", result="progress")
        else:
            self._consecutive_failures += 1
            inc_counter("sync_service_runs_total", result="failed")
        log.info(
            "autonomous sync run",
            target=target,
            imported=imported,
            caught_up=caught_up,
            backoff_s=self.backoff_s(),
        )
