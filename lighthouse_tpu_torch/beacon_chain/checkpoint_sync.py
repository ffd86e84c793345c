"""Checkpoint sync: boot a fresh node from a peer's finalized state.

The `--checkpoint-sync-url` flow (beacon_node/src/config.rs:510-561
ClientGenesis::CheckpointSyncUrl): fetch the remote's finalized SSZ state
and the block it descends from over the standard Beacon API, verify the
pair against the peer's *advertised* finalized root (trust is anchored in
that one root — everything else is recomputed locally via
`hash_tree_root`), and anchor a `BeaconChain` on it. The new node serves
the head forward immediately; history behind the anchor arrives later via
resumable backfill (network/sync/backfill.py), bounded by the DA window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ..metrics import REGISTRY, inc_counter, set_gauge
from ..utils.logging import get_logger

log = get_logger("checkpoint_sync")

REGISTRY.counter(
    "checkpoint_sync_boots_total",
    "nodes booted from a peer's finalized checkpoint",
).inc(0)
set_gauge("checkpoint_sync_anchor_slot", 0)


class CheckpointSyncError(RuntimeError):
    pass


@dataclass
class CheckpointData:
    """A verified (state, block) anchor pair fetched from a peer."""

    state: object
    block: object
    block_root: bytes
    finalized_epoch: int
    fetch_seconds: float


def fetch_finalized_checkpoint(
    url: str, E, timeout: float = 30.0
) -> CheckpointData:
    """Fetch + verify a peer's finalized checkpoint over the Beacon API.

    Three requests: finality_checkpoints (the advertised finalized root —
    the single trusted input), the finalized state SSZ (the
    /eth/v2/debug/beacon/states route), and the finalized block SSZ by
    that root. Verification recomputes both tree roots locally: the block
    must hash to the advertised root, and the block must commit to the
    state (`block.state_root == state.hash_tree_root()`). A peer serving a
    tampered state fails the second check no matter what it advertises."""
    from ..eth2 import BeaconNodeHttpClient
    from ..types.containers import build_types

    t0 = time.monotonic()
    client = BeaconNodeHttpClient(url, timeout=timeout)
    types = build_types(E)
    cps = client.get_finality_checkpoints("head")
    finalized = cps["finalized"]
    advertised_root = bytes.fromhex(finalized["root"].removeprefix("0x"))
    advertised_epoch = int(finalized["epoch"])
    if advertised_epoch == 0 or advertised_root == b"\x00" * 32:
        raise CheckpointSyncError(
            f"peer {url} has not finalized yet — nothing to anchor on"
        )
    state = types.decode_by_fork(
        "BeaconState", client.get_state_ssz("finalized")
    )
    block = types.decode_by_fork(
        "SignedBeaconBlock",
        client.get_block_ssz("0x" + advertised_root.hex()),
    )
    block_root = block.message.hash_tree_root()
    if block_root != advertised_root:
        raise CheckpointSyncError(
            f"peer block hashes to {block_root.hex()} but advertised "
            f"finalized root is {advertised_root.hex()}"
        )
    if bytes(block.message.state_root) != state.hash_tree_root():
        raise CheckpointSyncError(
            "peer state does not match the finalized block's state root"
        )
    return CheckpointData(
        state=state,
        block=block,
        block_root=block_root,
        finalized_epoch=advertised_epoch,
        fetch_seconds=time.monotonic() - t0,
    )


def checkpoint_boot(
    url: str,
    store,
    spec,
    E,
    slot_clock=None,
    timeout: float = 30.0,
    **chain_kwargs,
):
    """Fetch, verify, and anchor: the one-call boot used by tests and the
    testnet `join` verb. Builds a system clock from the fetched state's
    genesis_time when none is supplied (a joining node must share the
    fleet's clock, not restart time)."""
    from ..utils.slot_clock import SystemTimeSlotClock
    from .chain import BeaconChain

    data = fetch_finalized_checkpoint(url, E, timeout=timeout)
    if slot_clock is None:
        slot_clock = SystemTimeSlotClock(
            genesis_time=data.state.genesis_time,
            seconds_per_slot=spec.seconds_per_slot,
        )
    chain = BeaconChain.from_checkpoint(
        store,
        data.state,
        data.block,
        spec,
        E,
        slot_clock,
        wss_checkpoint=data.block_root,
        **chain_kwargs,
    )
    inc_counter("checkpoint_sync_boots_total")
    set_gauge("checkpoint_sync_anchor_slot", int(data.block.message.slot))
    log.info(
        "checkpoint boot",
        url=url,
        anchor_slot=int(data.block.message.slot),
        finalized_epoch=data.finalized_epoch,
        fetch_seconds=round(data.fetch_seconds, 3),
    )
    return chain
