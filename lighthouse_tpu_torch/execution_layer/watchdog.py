"""Execution-engine watchdog.

The execution_layer/src/lib.rs:599-618,1389 analog: wraps an
`ExecutionLayer`, tracking `EngineState` ONLINE/OFFLINE. Any transport
failure marks the engine offline (calls then fail fast), and a periodic
`upcheck` — a cheap forkchoiceUpdated probe — restores ONLINE so the
chain recovers without operator action."""

from __future__ import annotations

import time

from ..metrics import inc_counter, set_gauge
from ..utils.logging import get_logger
from . import (
    EngineState,
    ExecutionLayer,
    ExecutionLayerError,
    ForkchoiceState,
    PayloadStatusV1,
)

log = get_logger("engine_watchdog")


class EngineWatchdog(ExecutionLayer):
    UPCHECK_INTERVAL_S = 5.0

    def __init__(self, inner: ExecutionLayer, upcheck_interval: float | None = None):
        self.inner = inner
        self.state = EngineState.ONLINE
        self._last_failure = 0.0
        if upcheck_interval is not None:
            self.UPCHECK_INTERVAL_S = upcheck_interval

    # -- state machine ----------------------------------------------------

    def _mark_offline(self, err: Exception):
        if self.state is not EngineState.OFFLINE:
            log.warning("execution engine went offline", error=repr(err))
            inc_counter("execution_engine_offline_transitions_total")
        self.state = EngineState.OFFLINE
        self._last_failure = time.monotonic()
        set_gauge("execution_engine_online", 0)

    def _mark_online(self):
        if self.state is not EngineState.ONLINE:
            log.info("execution engine back online")
        self.state = EngineState.ONLINE
        set_gauge("execution_engine_online", 1)

    def upcheck(self) -> bool:
        """Probe the engine (a no-attribute forkchoiceUpdated on the last
        known head is the cheapest authenticated request)."""
        from .http import EngineTransportError

        try:
            self.inner.notify_forkchoice_updated(
                getattr(
                    self.inner,
                    "forkchoice_state",
                    ForkchoiceState(b"\x00" * 32, b"\x00" * 32, b"\x00" * 32),
                ),
                None,
            )
        except EngineTransportError as e:
            self._mark_offline(e)
            return False
        except Exception:  # noqa: BLE001 — app-level response: engine lives
            pass
        self._mark_online()
        return True

    def _guard(self):
        if self.state is EngineState.OFFLINE:
            if time.monotonic() - self._last_failure >= self.UPCHECK_INTERVAL_S:
                if self.upcheck():
                    return
            raise ExecutionLayerError("execution engine is offline")

    def _forward(self, fn, *args):
        from .http import EngineTransportError

        self._guard()
        try:
            result = fn(*args)
        except EngineTransportError as e:
            # only transport failures mean "engine down" — application
            # errors (SYNCING, JSON-RPC errors) come from a live engine
            self._mark_offline(e)
            raise
        except ExecutionLayerError:
            self._mark_online()
            raise
        self._mark_online()
        return result

    # -- ExecutionLayer surface -------------------------------------------

    def get_payload(self, parent_hash, attributes, fork):
        return self._forward(self.inner.get_payload, parent_hash, attributes, fork)

    def notify_new_payload(self, request) -> PayloadStatusV1:
        return self._forward(self.inner.notify_new_payload, request)

    def notify_forkchoice_updated(self, forkchoice_state, attributes):
        return self._forward(
            self.inner.notify_forkchoice_updated, forkchoice_state, attributes
        )

    def get_pow_block(self, block_hash):
        return self._forward(self.inner.get_pow_block, block_hash)
