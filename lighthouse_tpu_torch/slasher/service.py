"""Slasher service: bridges the chain into the slashing detector.

The slasher/service crate analog: subscribes the slasher to everything
the node verifies (gossip/block attestations as IndexedAttestations,
block headers), drives `process_queued` once per epoch, and injects any
found slashings into the operation pool so the node's own proposals
carry the proofs (service/src/lib.rs feeds the op pool the same way).

Epoch processing rides its OWN beacon_processor lane when a processor is
offered (`WorkType.SLASHER_PROCESS`, lowest priority): the NetworkService
slot tick submits the cycle instead of running it inline, so detection
work — array programs over a whole epoch's attestation flood — lands on
a worker thread with free queue-wait/run histograms, never on the
heartbeat thread or a gossip reader. Epoch claims are atomic, so the
client slot timer and the network slot tick can both fire without
double-processing an epoch.
"""

from __future__ import annotations

import threading

from ..metrics import inc_counter
from ..utils.logging import get_logger
from . import Slasher

log = get_logger("slasher.service")


class SlasherService:
    def __init__(self, chain, slasher=None, store=None):
        self.chain = chain
        if slasher is None:
            # Persist detection history through the node's hot KV store
            # (own columns — the reference keeps a dedicated LMDB; the
            # ItemStore seam gives the same durability here). Memory-backed
            # nodes skip write-through: serializing into a store that dies
            # with the process is pure overhead.
            if store is None and getattr(chain, "store", None) is not None:
                from ..store.kv import MemoryStore

                hot = chain.store.hot
                if not isinstance(hot, MemoryStore):
                    store = hot
            slasher = Slasher(chain.E, store=store)
        self.slasher = slasher
        self._last_processed_epoch = -1
        self._epoch_lock = threading.Lock()
        # cycles must never overlap: the engines are not thread-safe, and
        # a backlogged SLASHER_PROCESS queue (or the inline backpressure
        # fallback racing a queued run) can otherwise hand two epochs to
        # two workers at once
        self._run_lock = threading.Lock()
        # hook into the chain's verification paths
        chain.slasher_service = self

    # -- chain feed (called by the chain on verified objects) ------------

    def observe_indexed_attestation(self, indexed):
        self.slasher.accept_attestation(indexed)

    def observe_indexed_attestations(self, batch):
        """Whole drained gossip batch in one call (the columnar engine
        detects a cycle's queue as one array program anyway)."""
        for indexed in batch:
            self.slasher.accept_attestation(indexed)

    def observe_block(self, signed_block):
        """Feed the proposal as a signed header (block queues track
        double proposals per slot)."""
        t = self.chain.types
        m = signed_block.message
        header = t.BeaconBlockHeader(
            slot=m.slot,
            proposer_index=m.proposer_index,
            parent_root=m.parent_root,
            state_root=m.state_root,
            body_root=m.body.hash_tree_root(),
        )
        self.slasher.accept_block_header(
            t.SignedBeaconBlockHeader(
                message=header, signature=signed_block.signature
            )
        )

    # -- periodic processing ---------------------------------------------

    def _claim_epoch(self, epoch: int) -> bool:
        """Atomically claim `epoch` for processing: exactly one of the
        competing slot drivers (client timer, network slot tick) wins."""
        with self._epoch_lock:
            if epoch <= self._last_processed_epoch:
                return False
            self._last_processed_epoch = epoch
            return True

    def _unclaim_epoch(self, epoch: int):
        with self._epoch_lock:
            if self._last_processed_epoch == epoch:
                self._last_processed_epoch = epoch - 1

    def on_slot(self, slot: int, processor=None):
        """Once per epoch edge: run (or queue) the detection cycle.

        With a `processor`, the cycle is submitted on the lowest-priority
        SLASHER_PROCESS lane and this returns None immediately; a refused
        submit (backpressure/shutdown race) UNCLAIMS the epoch so the
        next slot tick retries — never runs the multi-hundred-ms cycle
        inline on the caller (the heartbeat/slot-tick thread must stay
        clean; the refusal is already drop-counted by the processor).
        Without a processor, the cycle runs inline and returns its stats
        (tests and timer-only nodes)."""
        epoch = slot // self.chain.E.SLOTS_PER_EPOCH
        if not self._claim_epoch(epoch):
            return None
        if processor is not None:
            from ..beacon_processor import WorkType

            if not processor.submit(
                WorkType.SLASHER_PROCESS, epoch, self._process_epoch
            ):
                self._unclaim_epoch(epoch)
            return None
        return self._process_epoch(epoch)

    def _process_epoch(self, epoch: int):
        with self._run_lock:
            return self._process_epoch_locked(epoch)

    def _process_epoch_locked(self, epoch: int):
        stats = self.slasher.process_queued(epoch)
        atts, props = self.slasher.drain_slashings()
        for kind, slashings, process in (
            ("attester", atts, self.chain.process_attester_slashing),
            ("proposer", props, self.chain.process_proposer_slashing),
        ):
            for slashing in slashings:
                try:
                    process(slashing)
                except Exception as e:  # noqa: BLE001 — e.g. already slashed
                    log.warning(
                        "found slashing not poolable", kind=kind, error=repr(e)
                    )
                    continue
                inc_counter("slasher_slashings_found_total", kind=kind)
                log.warning("slashing detected and pooled", kind=kind)
        return stats
