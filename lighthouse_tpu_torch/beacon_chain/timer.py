"""Per-slot tick service.

The `beacon_node/timer` analog (src/lib.rs:1-9, 34 LoC in the reference):
fires a callback at every slot start, driving head recomputation, fork
choice ticks, and reprocess-queue release. Test-friendly: `tick()` can be
driven manually against a ManualSlotClock instead of running the thread."""

from __future__ import annotations

import threading

from ..metrics import inc_counter, set_gauge
from ..utils.slot_clock import SlotClock


class SlotTimer:
    def __init__(self, slot_clock: SlotClock, on_slot, executor=None):
        self.slot_clock = slot_clock
        self.on_slot = on_slot
        self._stop = threading.Event()
        self._last_slot = None
        self._executor = executor
        self._thread = None

    def tick(self) -> bool:
        """Fire `on_slot(slot)` if a new slot started; True when fired."""
        slot = self.slot_clock.now()
        if slot == self._last_slot:
            return False
        self._last_slot = slot
        set_gauge("slot_timer_current_slot", slot)
        inc_counter("slot_timer_ticks_total")
        self.on_slot(slot)
        return True

    def start(self):
        """Background mode against a real clock."""

        def loop():
            while not self._stop.is_set():
                self.tick()
                self._stop.wait(timeout=self.slot_clock.seconds_per_slot / 4)

        if self._executor is not None:
            self._thread = self._executor.spawn(loop, "slot_timer")
        else:
            self._thread = threading.Thread(
                target=loop, daemon=True, name="slot_timer"
            )
            self._thread.start()

    def stop(self):
        self._stop.set()
