"""Altair block processing: the sync-aggregate signature set.

Copied from lighthouse_tpu/state_processing/altair.py
(`sync_aggregate_signature_set`); the rest of that module (participation
flags, the epoch sweep over K7) waits for the state-processing slice.
"""

from __future__ import annotations

from ..types.chain_spec import ChainSpec
from .accessors import compute_epoch_at_slot, get_block_root_at_slot, get_domain


def sync_aggregate_signature_set(
    state, sync_aggregate, slot: int, spec: ChainSpec, E
):
    """Signature set for a block's sync aggregate: participants sign the
    previous slot's block root with the SYNC_COMMITTEE domain
    (signature_sets.rs sync_aggregate_signature_set)."""
    from ..crypto import bls
    from ..types.chain_spec import Domain, compute_signing_root
    from .signature_sets import pubkey_from_bytes

    previous_slot = max(slot, 1) - 1
    domain = get_domain(
        state,
        Domain.SYNC_COMMITTEE,
        compute_epoch_at_slot(previous_slot, E),
        spec,
        E,
    )
    root = get_block_root_at_slot(state, previous_slot, E)
    message = compute_signing_root(root, domain)
    pubkeys = [
        pubkey_from_bytes(pk)
        for pk, bit in zip(
            state.current_sync_committee.pubkeys,
            sync_aggregate.sync_committee_bits,
        )
        if bit
    ]
    return bls.SignatureSet(
        signature=bls.Signature(sync_aggregate.sync_committee_signature),
        pubkeys=pubkeys,
        message=message,
    )
