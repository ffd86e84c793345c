"""Slot processing: root caching + epoch boundary dispatch.

Counterpart of lighthouse_tpu/state_processing/per_slot.py, copied.

Mirrors state_processing's `per_slot_processing` (state root caching into the
historical vectors, epoch transition at boundaries, fork upgrades at
scheduled epochs).
"""

from __future__ import annotations

from ..types.chain_spec import ChainSpec
from .per_epoch import process_epoch


def process_slot(state, E, state_root: bytes | None = None):
    previous_state_root = (
        state_root if state_root is not None else state.hash_tree_root()
    )
    state.state_roots[state.slot % E.SLOTS_PER_HISTORICAL_ROOT] = previous_state_root
    if state.latest_block_header.state_root == b"\x00" * 32:
        state.latest_block_header.state_root = previous_state_root
    previous_block_root = state.latest_block_header.hash_tree_root()
    state.block_roots[state.slot % E.SLOTS_PER_HISTORICAL_ROOT] = previous_block_root


def per_slot_processing(state, spec: ChainSpec, E, state_root: bytes | None = None):
    """Advance `state` by one slot in place. `state_root` (if known) skips
    re-hashing the state (the reference threads this optimization through,
    state_processing/src/per_slot_processing.rs)."""
    process_slot(state, E, state_root)
    if (state.slot + 1) % E.SLOTS_PER_EPOCH == 0:
        process_epoch(state, spec, E)
    state.slot += 1
    _maybe_upgrade_fork(state, spec, E)


def _maybe_upgrade_fork(state, spec: ChainSpec, E):
    """Fork upgrade hook at epoch starts (state_processing/src/upgrade/*.rs):
    swaps the state to the scheduled fork's variant in place."""
    if state.slot % E.SLOTS_PER_EPOCH != 0:
        return
    epoch = state.slot // E.SLOTS_PER_EPOCH
    from ..types.containers import build_types

    t = build_types(E)
    target_fork = spec.fork_name_at_epoch(epoch)
    current_fork = t.fork_of_state(state)
    if target_fork != current_fork:
        from .upgrades import apply_upgrades

        apply_upgrades(state, current_fork, target_fork, spec, E)


def state_root_and_advance(state, spec: ChainSpec, E) -> bytes:
    """Compute the state root then advance a slot reusing it."""
    root = state.hash_tree_root()
    per_slot_processing(state, spec, E, state_root=root)
    return root
