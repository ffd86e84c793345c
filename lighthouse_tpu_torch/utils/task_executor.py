"""Named task spawning with metrics + shutdown signalling.

The `common/task_executor` analog (src/lib.rs:14,169,207,374): spawn named
daemon tasks, count spawns/exits/panics in the global metrics registry, and
propagate a shutdown signal so a panicking critical task can bring the
process down in an orderly way."""

from __future__ import annotations

import threading

from ..metrics import inc_counter


class ShutdownSignal:
    def __init__(self):
        self._event = threading.Event()
        self.reason: str | None = None

    def trigger(self, reason: str):
        self.reason = reason
        self._event.set()

    def is_triggered(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)


class TaskExecutor:
    def __init__(self, shutdown: ShutdownSignal | None = None):
        self.shutdown_signal = shutdown if shutdown is not None else ShutdownSignal()
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()

    def spawn(self, fn, name: str, critical: bool = False) -> threading.Thread:
        """Run `fn()` on a named daemon thread. A critical task's exception
        triggers shutdown (task_executor/src/lib.rs:124-147)."""

        def runner():
            inc_counter("async_tasks_spawned_total", task=name)
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — the panic hook
                inc_counter("async_tasks_panicked_total", task=name)
                if critical:
                    self.shutdown_signal.trigger(f"critical task {name} failed: {e}")
            finally:
                inc_counter("async_tasks_completed_total", task=name)

        t = threading.Thread(target=runner, daemon=True, name=name)
        with self._lock:
            self._threads.append(t)
        t.start()
        return t

    def join_all(self, timeout: float = 5.0):
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=timeout)
