"""Per-validator performance monitoring.

The beacon_chain/src/validator_monitor.rs analog (:1-3): operators
register validator indices/pubkeys to watch; the chain feeds it every
imported block and head update, and it records per-validator hits —
blocks proposed, attestations included (with inclusion delay), missed
attestations at epoch rollover — as metrics and structured logs."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..metrics import inc_counter, set_gauge
from ..utils.logging import get_logger

log = get_logger("validator_monitor")

#: retained per-validator inclusion-delay window (slots). Doubles as the
#: duplicate-inclusion dedup horizon — a long soak previously grew the
#: dict one entry per attested slot, forever.
MAX_INCLUSION_DELAY_SLOTS = 64


@dataclass
class MonitoredValidator:
    index: int
    pubkey: bytes
    blocks_proposed: int = 0
    attestations_included: int = 0
    attestations_missed: int = 0
    #: slot -> inclusion delay, bounded to the last
    #: MAX_INCLUSION_DELAY_SLOTS distinct attested slots (insertion order)
    inclusion_delays: dict = field(default_factory=dict)
    #: epochs in which we saw an attestation included (pruned at rollover)
    attested_epochs: set = field(default_factory=set)

    def record_inclusion(self, slot: int, delay: int) -> bool:
        """True if this slot's inclusion is new (first block to include
        the vote wins, as the reference credits best-inclusion)."""
        if slot in self.inclusion_delays:
            return False
        self.inclusion_delays[slot] = delay
        while len(self.inclusion_delays) > MAX_INCLUSION_DELAY_SLOTS:
            self.inclusion_delays.pop(next(iter(self.inclusion_delays)))
        return True


class ValidatorMonitor:
    def __init__(self, E, auto_register: bool = False):
        self.E = E
        #: auto-register every validator seen proposing/attesting
        #: (--validator-monitor-auto)
        self.auto_register = auto_register
        self._by_index: dict[int, MonitoredValidator] = {}
        self._last_completed_epoch = -1

    # -- registration (validator_monitor.rs add_validator_*) -------------

    def add_validator(self, index: int, pubkey: bytes = b""):
        if index not in self._by_index:
            self._by_index[index] = MonitoredValidator(index, bytes(pubkey))

    def monitored_indices(self) -> set[int]:
        return set(self._by_index)

    def summary(self, index: int) -> MonitoredValidator | None:
        return self._by_index.get(index)

    # -- chain feed ------------------------------------------------------

    def process_block(self, block, proposer_index: int, state, spec):
        """Called per imported block: credit the proposer and every
        monitored attester whose vote the block includes."""
        v = self._by_index.get(proposer_index)
        if self.auto_register and v is None:
            self.add_validator(proposer_index)
            v = self._by_index[proposer_index]
        if v is not None:
            v.blocks_proposed += 1
            inc_counter("validator_monitor_blocks_proposed_total")
            log.info(
                "monitored validator proposed block",
                validator=proposer_index,
                slot=block.slot,
            )

        from ..state_processing.accessors import (
            attesting_indices_array,
            compute_epoch_at_slot,
        )

        for att in block.body.attestations:
            data = att.data
            epoch = compute_epoch_at_slot(data.slot, self.E)
            try:
                # the shared columnar source: one vectorized gather
                # over the committee permutation instead of a Python walk
                # of every committee position per attestation
                attesters = attesting_indices_array(
                    state, data, att.aggregation_bits, self.E
                )
            except Exception:  # noqa: BLE001 — cross-epoch edge; skip credit
                continue
            if self.auto_register:
                for vi in attesters.tolist():
                    self.add_validator(vi)  # --validator-monitor-auto
            if not self._by_index:
                continue
            delay = max(1, block.slot - data.slot)
            for vi in attesters.tolist():
                mv = self._by_index.get(vi)
                if mv is None or not mv.record_inclusion(int(data.slot), delay):
                    continue
                mv.attestations_included += 1
                mv.attested_epochs.add(epoch)
                inc_counter("validator_monitor_attestations_included_total")
                log.info(
                    "monitored validator attestation included",
                    validator=vi,
                    slot=data.slot,
                    delay=delay,
                )

    def process_epoch_rollover(self, completed_epoch: int):
        """Called once per completed epoch: any monitored validator with no
        included attestation for that epoch is a miss (the reference's
        per-epoch summaries)."""
        if completed_epoch <= self._last_completed_epoch:
            return
        self._last_completed_epoch = completed_epoch
        for mv in self._by_index.values():
            if completed_epoch not in mv.attested_epochs:
                mv.attestations_missed += 1
                inc_counter("validator_monitor_attestations_missed_total")
                log.warning(
                    "monitored validator missed attestation",
                    validator=mv.index,
                    epoch=completed_epoch,
                )
            # summarized epochs never get re-checked: keep a short
            # retention window for operator queries, drop the rest so the
            # set stays bounded on a long soak (mirrors inclusion_delays)
            mv.attested_epochs = {
                e for e in mv.attested_epochs if e >= completed_epoch - 4
            }
        set_gauge("validator_monitor_validators", len(self._by_index))
