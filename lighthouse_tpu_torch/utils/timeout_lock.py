"""Loud-failure locks for shared chain structures.

The beacon_chain/src/timeout_rw_lock.rs analog: a readers-writer lock
whose acquisitions time out and raise instead of deadlocking silently —
lock starvation is a bug to surface, not to wait out (the reference fails
the same way after 1s and guards its shuffling/pubkey caches with it,
beacon_chain.rs:465-471). Also `LockTimeout` carries the lock's name so
the stall is attributable."""

from __future__ import annotations

import threading

from ..metrics import inc_counter

DEFAULT_TIMEOUT = 5.0  # generous: CI boxes stall; production wants ~1s


class LockTimeout(RuntimeError):
    def __init__(self, name: str, mode: str, timeout: float):
        super().__init__(
            f"timed out acquiring {mode} lock '{name}' after {timeout}s — "
            "possible deadlock or starved writer"
        )


class TimeoutRwLock:
    """Writer-preferring RW lock with timeouts. Reentrancy is NOT
    supported (matching parking_lot::RwLock semantics — a thread
    re-acquiring deadlocks by design and the timeout surfaces it)."""

    def __init__(self, name: str = "lock", timeout: float = DEFAULT_TIMEOUT):
        self.name = name
        self.timeout = timeout
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    # -- read side -------------------------------------------------------

    def acquire_read(self, timeout: float | None = None):
        t = self.timeout if timeout is None else timeout
        with self._cond:
            # writer preference: don't starve pending writers behind a
            # stream of readers
            if not self._cond.wait_for(
                lambda: not self._writer and self._writers_waiting == 0,
                timeout=t,
            ):
                inc_counter("lock_timeouts_total", lock=self.name, mode="read")
                raise LockTimeout(self.name, "read", t)
            self._readers += 1
        return _Guard(self._release_read)

    def _release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    # -- write side ------------------------------------------------------

    def acquire_write(self, timeout: float | None = None):
        t = self.timeout if timeout is None else timeout
        with self._cond:
            self._writers_waiting += 1
            try:
                if not self._cond.wait_for(
                    lambda: not self._writer and self._readers == 0,
                    timeout=t,
                ):
                    inc_counter(
                        "lock_timeouts_total", lock=self.name, mode="write"
                    )
                    raise LockTimeout(self.name, "write", t)
                self._writer = True
            finally:
                self._writers_waiting -= 1
        return _Guard(self._release_write)

    def _release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class _Guard:
    """Context-manager release handle."""

    __slots__ = ("_release", "_done")

    def __init__(self, release):
        self._release = release
        self._done = False

    def release(self):
        if not self._done:
            self._done = True
            self._release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
