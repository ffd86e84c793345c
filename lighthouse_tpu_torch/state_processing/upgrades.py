"""Fork upgrade functions (consensus/state_processing/src/upgrade/*.rs).

Counterpart of lighthouse_tpu/state_processing/upgrades.py, copied.

Each `upgrade_to_*` mutates the state IN PLACE by swapping its container
class to the next fork's variant and installing the new fields — the Python
analog of the reference's superstruct variant map, chosen so
`per_slot_processing`'s in-place contract holds across fork boundaries
(upgrades fire at epoch-start slots, per_slot_processing.rs).
"""

from __future__ import annotations

from ..types.chain_spec import ChainSpec, ForkName
from .accessors import get_current_epoch, invalidate_caches
from .altair import (
    add_flag,
    get_attestation_participation_flag_indices,
    get_next_sync_committee,
)


def _persistent_like(template, values):
    """Match the persistence of an existing field: a chain whose balances
    ride PersistentList gets new registry-scale lists the same way."""
    from ..ssz.persistent import PersistentList

    if isinstance(template, PersistentList):
        return PersistentList(values)
    return values


def _participation_like(template, n: int):
    """Fresh zeroed participation flags matching the chain's persistence
    (PersistentByteList on tree-states chains, bytearray otherwise — the
    resident columns only engage when every mirrored field is persistent)."""
    from ..ssz.persistent import PersistentByteList, PersistentList

    if isinstance(template, PersistentList):
        return PersistentByteList(bytes(n))
    return bytearray(n)


def _swap_class(state, new_cls, new_field_values: dict):
    """Re-class `state` to the next fork variant; new fields are coerced by
    the container's field machinery."""
    state.__class__ = new_cls
    for fname, value in new_field_values.items():
        setattr(state, fname, value)
    # Drop anything the new variant doesn't declare: superseded fields (e.g.
    # pending-attestation lists after altair) and `_lh_*` runtime caches.
    declared = set(new_cls._fields)
    for stale in [k for k in list(state.__dict__) if k not in declared]:
        object.__delattr__(state, stale)
    invalidate_caches(state)


def _bump_fork(state, t, version: bytes, epoch: int):
    state.fork = t.Fork(
        previous_version=state.fork.current_version,
        current_version=version,
        epoch=epoch,
    )


def translate_participation(state, pending_attestations, E):
    """upgrade/altair.rs translate_participation: replay phase0 pending
    attestations into previous-epoch participation flags."""
    from .accessors import get_attesting_indices

    for attestation in pending_attestations:
        data = attestation.data
        inclusion_delay = attestation.inclusion_delay
        flag_indices = get_attestation_participation_flag_indices(
            state, data, inclusion_delay, E, ForkName.ALTAIR
        )
        indices = get_attesting_indices(
            state, data, attestation.aggregation_bits, E
        )
        for index in indices:
            flags = state.previous_epoch_participation[index]
            for flag_index in flag_indices:
                flags = add_flag(flags, flag_index)
            state.previous_epoch_participation[index] = flags


def upgrade_to_altair(state, spec: ChainSpec, E):
    from ..types.containers import build_types

    t = build_types(E)
    epoch = get_current_epoch(state, E)
    n = len(state.validators)
    pending = list(state.previous_epoch_attestations)
    _swap_class(
        state,
        t.BeaconStateAltair,
        dict(
            previous_epoch_participation=_participation_like(
                state.balances, n
            ),
            current_epoch_participation=_participation_like(
                state.balances, n
            ),
            # stays structurally-shared across copies if balances already is
            inactivity_scores=_persistent_like(state.balances, [0] * n),
            current_sync_committee=t.SyncCommittee.default(),
            next_sync_committee=t.SyncCommittee.default(),
        ),
    )
    _bump_fork(state, t, spec.altair_fork_version, epoch)
    translate_participation(state, pending, E)
    # Both committees sample the same next-epoch seed at the upgrade point
    # (upgrade/altair.rs sets both from one computation).
    sync_committee = get_next_sync_committee(state, E)
    state.current_sync_committee = sync_committee
    state.next_sync_committee = sync_committee.copy()


def upgrade_to_bellatrix(state, spec: ChainSpec, E):
    from ..types.containers import build_types

    t = build_types(E)
    epoch = get_current_epoch(state, E)
    _swap_class(
        state,
        t.BeaconStateBellatrix,
        dict(latest_execution_payload_header=t.ExecutionPayloadHeader.default()),
    )
    _bump_fork(state, t, spec.bellatrix_fork_version, epoch)


def upgrade_to_capella(state, spec: ChainSpec, E):
    from ..types.containers import build_types

    t = build_types(E)
    epoch = get_current_epoch(state, E)
    old_header = state.latest_execution_payload_header
    new_header = t.ExecutionPayloadHeaderCapella(
        **{f: getattr(old_header, f) for f in type(old_header)._fields},
        withdrawals_root=b"\x00" * 32,
    )
    _swap_class(
        state,
        t.BeaconStateCapella,
        dict(
            latest_execution_payload_header=new_header,
            next_withdrawal_index=0,
            next_withdrawal_validator_index=0,
            historical_summaries=[],
        ),
    )
    _bump_fork(state, t, spec.capella_fork_version, epoch)


def upgrade_to_deneb(state, spec: ChainSpec, E):
    from ..types.containers import build_types

    t = build_types(E)
    epoch = get_current_epoch(state, E)
    old_header = state.latest_execution_payload_header
    new_header = t.ExecutionPayloadHeaderDeneb(
        **{f: getattr(old_header, f) for f in type(old_header)._fields},
        blob_gas_used=0,
        excess_blob_gas=0,
    )
    _swap_class(
        state,
        t.BeaconStateDeneb,
        dict(latest_execution_payload_header=new_header),
    )
    _bump_fork(state, t, spec.deneb_fork_version, epoch)


def _upgrade_to_electra(state, spec: ChainSpec, E):
    from .electra import upgrade_to_electra

    upgrade_to_electra(state, spec, E)


UPGRADES = {
    ForkName.ALTAIR: upgrade_to_altair,
    ForkName.BELLATRIX: upgrade_to_bellatrix,
    ForkName.CAPELLA: upgrade_to_capella,
    ForkName.DENEB: upgrade_to_deneb,
    ForkName.ELECTRA: _upgrade_to_electra,
}

_ORDER = [
    ForkName.PHASE0,
    ForkName.ALTAIR,
    ForkName.BELLATRIX,
    ForkName.CAPELLA,
    ForkName.DENEB,
    ForkName.ELECTRA,
]


def apply_upgrades(state, current_fork: ForkName, target_fork: ForkName, spec, E):
    """Apply every scheduled upgrade between current and target (handles
    multiple forks landing at the same epoch, as minimal-preset test specs
    schedule)."""
    ci, ti = _ORDER.index(current_fork), _ORDER.index(target_fork)
    for fork in _ORDER[ci + 1 : ti + 1]:
        UPGRADES[fork](state, spec, E)
