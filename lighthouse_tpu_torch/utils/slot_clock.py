"""Slot clocks (common/slot_clock equivalent): wall-clock slots for
production, a manually-advanced clock for tests
(system_time_slot_clock.rs / manual_slot_clock.rs)."""

from __future__ import annotations

import time


class SlotClock:
    #: both concrete clocks carry this; declared for the deadline helpers
    seconds_per_slot: int

    def now(self) -> int:
        raise NotImplementedError

    def slot_start_seconds(self, slot: int) -> int:
        raise NotImplementedError

    def seconds_into_slot(self) -> float:
        raise NotImplementedError

    def slot_offset_seconds(self, slot: int) -> float:
        """Seconds elapsed since the START of `slot`, on this clock's own
        timeline — the slot-anchored delay the block/attestation latency
        histograms observe (the reference's `seconds_from_current_slot_start`
        family). Negative for future slots."""
        raise NotImplementedError

    @property
    def attestation_deadline_offset(self) -> float:
        """Slot-relative attestation deadline: SECONDS_PER_SLOT/3, the
        instant attesters vote (`unagg_attestation_production_delay`). A
        block observed past this offset arrived after the voters already
        committed — the lateness bar for both the late-head WARNING and
        the proposer re-org decision."""
        return self.seconds_per_slot / 3

    def is_past_attestation_deadline(self, slot: int) -> bool:
        """Whether `slot`'s attestation deadline has passed on this
        clock (true for every earlier slot)."""
        return self.slot_offset_seconds(slot) > self.attestation_deadline_offset


class SystemTimeSlotClock(SlotClock):
    def __init__(self, genesis_time: int, seconds_per_slot: int):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot

    def now(self) -> int:
        t = time.time()
        if t < self.genesis_time:
            return 0
        return int(t - self.genesis_time) // self.seconds_per_slot

    def slot_start_seconds(self, slot: int) -> int:
        return self.genesis_time + slot * self.seconds_per_slot

    def seconds_into_slot(self) -> float:
        return (time.time() - self.genesis_time) % self.seconds_per_slot

    def slot_offset_seconds(self, slot: int) -> float:
        return time.time() - self.slot_start_seconds(slot)


class ManualSlotClock(SlotClock):
    """Test clock advanced by hand (manual_slot_clock.rs). Sub-slot time
    is manual too (`set_seconds_into_slot`) so tests can place an event
    at an exact slot-relative instant — e.g. a deliberately late head."""

    def __init__(self, genesis_time: int = 0, seconds_per_slot: int = 12):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot
        self._slot = 0
        self._seconds_into_slot = 0.0

    def now(self) -> int:
        return self._slot

    def set_slot(self, slot: int):
        self._slot = slot

    def advance(self, slots: int = 1):
        self._slot += slots

    def slot_start_seconds(self, slot: int) -> int:
        return self.genesis_time + slot * self.seconds_per_slot

    def set_seconds_into_slot(self, seconds: float):
        self._seconds_into_slot = float(seconds)

    def seconds_into_slot(self) -> float:
        return self._seconds_into_slot

    def slot_offset_seconds(self, slot: int) -> float:
        return (
            (self._slot - slot) * self.seconds_per_slot
            + self._seconds_into_slot
        )
