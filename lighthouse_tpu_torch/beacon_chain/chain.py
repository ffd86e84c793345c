"""Chain-level state helpers (counterpart of lighthouse_tpu/beacon_chain/chain.py).

Only two helpers are ported so far: `_make_persistent` gives a state the
tree-states representation that block import hashes through the
dirty-index caches of ssz/cached_tree_hash.py, and `empty_sync_aggregate`
is the state harness's empty sync aggregate.
"""

from __future__ import annotations


def _make_persistent(state):
    """Swap registry-scale list fields to persistent (structurally-shared)
    lists in place — the tree-states backbone (beacon_state.rs:34,371)."""
    from ..ssz.persistent import (
        PersistentByteList,
        PersistentContainerList,
        PersistentList,
    )

    for fname in ("balances", "inactivity_scores"):
        v = getattr(state, fname, None)
        if isinstance(v, list):
            object.__setattr__(state, fname, PersistentList(v))
    for fname in (
        "previous_epoch_participation",
        "current_epoch_participation",
    ):
        v = getattr(state, fname, None)
        if isinstance(v, bytearray):
            object.__setattr__(state, fname, PersistentByteList(v))
    v = getattr(state, "validators", None)
    if isinstance(v, list):
        object.__setattr__(state, "validators", PersistentContainerList(v))


def empty_sync_aggregate(types, E):
    """No-participation sync aggregate: all-zero bits + the G2 infinity
    signature (required by eth_fast_aggregate_verify's empty rule)."""
    from ..crypto import bls

    return types.SyncAggregate(
        sync_committee_bits=[False] * E.SYNC_COMMITTEE_SIZE,
        sync_committee_signature=bls.INFINITY_SIGNATURE,
    )
