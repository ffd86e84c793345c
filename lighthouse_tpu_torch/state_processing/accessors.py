"""Spec accessors that the signature-set constructors read.

Copied from lighthouse_tpu/state_processing/accessors.py (the epoch math,
`get_domain` and `get_block_root_at_slot`); the rest of that module waits
for the state-processing slice.
"""

from __future__ import annotations

from ..types.chain_spec import ChainSpec


# ---------------------------------------------------------------------------
# Epoch / slot math
# ---------------------------------------------------------------------------


def compute_epoch_at_slot(slot: int, E) -> int:
    return slot // E.SLOTS_PER_EPOCH


def compute_start_slot_at_epoch(epoch: int, E) -> int:
    return epoch * E.SLOTS_PER_EPOCH


def get_current_epoch(state, E) -> int:
    return compute_epoch_at_slot(state.slot, E)


def get_previous_epoch(state, E) -> int:
    cur = get_current_epoch(state, E)
    return cur - 1 if cur > 0 else 0


# ---------------------------------------------------------------------------
# Block roots
# ---------------------------------------------------------------------------


def get_block_root_at_slot(state, slot: int, E) -> bytes:
    if not slot < state.slot <= slot + E.SLOTS_PER_HISTORICAL_ROOT:
        raise ValueError(f"block root for slot {slot} not available at {state.slot}")
    return state.block_roots[slot % E.SLOTS_PER_HISTORICAL_ROOT]


def get_block_root(state, epoch: int, E) -> bytes:
    return get_block_root_at_slot(state, compute_start_slot_at_epoch(epoch, E), E)


# ---------------------------------------------------------------------------
# Domains
# ---------------------------------------------------------------------------


def get_domain(state, domain_type: int, epoch: int | None, spec: ChainSpec, E) -> bytes:
    epoch = get_current_epoch(state, E) if epoch is None else epoch
    return spec.get_domain(
        epoch, domain_type, state.fork, state.genesis_validators_root
    )
