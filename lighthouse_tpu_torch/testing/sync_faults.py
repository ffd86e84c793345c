"""Fault-injection peer for sync-engine tests.

A `FaultyNetworkService` is a real `NetworkService` (real sockets, real
RPC codec) whose server-side data providers misbehave on a script: drop
requests, truncate batches, serve self-consistent forked batches, answer
slowly, advertise a stale/lying Status, or go dark mid-sync. Faults are
keyed off a per-service BlocksByRange request counter so tests can write
deterministic scripts ("truncate the first response, then behave").

The injected faults mirror the adversary matrix the sync engine is built
against (BENCH_NOTES.md "Sync subsystem" documents the expected handling
for each row).

This is the single-peer ancestor of the fleet-scale fault plane:
testing/testnet.py generalizes these per-peer scripts into a
topology-wide `FaultPlane` (partitions, eclipses, delays, floods,
equivocation) over N full nodes, with chain-health invariants as the
oracle — see SCENARIOS.md.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..network import NetworkService
from ..network import messages as M
from ..network.rpc import RpcError


@dataclass
class FaultPlan:
    #: first N BlocksByRange requests fail mid-request (server error chunk)
    drop_first: int = 0
    #: first N responses return only the first half of the batch
    truncate_first: int = 0
    #: first N responses are self-consistent forks (internally linked,
    #: invalid state roots — passes the download hash-chain check, fails
    #: import)
    fork_first: int = 0
    #: every response sleeps this long first (slow peer)
    delay_s: float = 0.0
    #: after N BlocksByRange requests the peer stops serving entirely
    #: (mid-sync disconnect)
    disconnect_after: int | None = None
    #: Status advertises head_slot + this (stale/lying status)
    stale_status_extra: int = 0


class FaultyNetworkService(NetworkService):
    def __init__(self, chain, plan: FaultPlan | None = None, **kwargs):
        super().__init__(chain, **kwargs)
        self.plan = plan or FaultPlan()
        self.range_requests = 0
        self._fault_lock = threading.Lock()

    def local_status(self) -> M.StatusMessage:
        st = super().local_status()
        if not self.plan.stale_status_extra:
            return st
        return M.StatusMessage(
            fork_digest=st.fork_digest,
            finalized_root=st.finalized_root,
            finalized_epoch=st.finalized_epoch,
            head_root=st.head_root,
            head_slot=int(st.head_slot) + self.plan.stale_status_extra,
        )

    def blocks_by_range(self, start_slot: int, count: int):
        with self._fault_lock:
            self.range_requests += 1
            n = self.range_requests
        p = self.plan
        if p.disconnect_after is not None and n > p.disconnect_after:
            raise RpcError("injected: peer disconnected")
        if p.delay_s:
            time.sleep(p.delay_s)
        if n <= p.drop_first:
            raise RpcError("injected: dropped request")
        blocks = super().blocks_by_range(start_slot, count)
        if n <= p.truncate_first and len(blocks) > 1:
            return blocks[: len(blocks) // 2]
        if n <= p.fork_first and blocks:
            return fork_blocks(blocks)
        return blocks


def fork_blocks(blocks) -> list:
    """A self-consistent fork of `blocks`: every state root is garbage but
    parent links are re-derived so the batch passes the download-time
    hash-chain check and only fails at import (state-root verification).
    Copies — the serving chain's own objects stay untouched."""
    out = []
    prev_root = None
    for i, signed in enumerate(blocks):
        forged = signed.copy()
        forged.message.state_root = bytes([0x66]) * 31 + bytes([i & 0xFF])
        if prev_root is not None:
            forged.message.parent_root = prev_root
        prev_root = forged.message.hash_tree_root()
        out.append(forged)
    return out
