"""Signature-set constructors: consensus objects → (message, pubkeys, sig).

Counterpart of lighthouse_tpu/state_processing/signature_sets.py, copied.
Mirrors consensus/state_processing/src/per_block_processing/signature_sets.rs:
56-610 — each function maps one signed consensus object to a `SignatureSet`
for batched verification. Messages are SigningData roots
(signing_data.rs:22-35).
"""

from __future__ import annotations

from ..crypto import bls
from ..types.chain_spec import ChainSpec, Domain, compute_signing_root
from .accessors import compute_epoch_at_slot, get_domain

# PublicKey OBJECT cache: the reference keeps every validator pubkey
# decompressed in memory (validator_pubkey_cache.rs:17). Sized from the bls
# point cache (one knob, LIGHTHOUSE_TPU_BLS_PK_CACHE, tunes both). The
# decompressed point tuples are allocated once in bls._PK_CACHE and shared
# by reference into each PublicKey's memoized `_point`; this LRU only adds
# the thin object wrappers, saving re-wrapping on the per-block lookup path.
_PUBKEY_CACHE = bls.LruCache(bls._PK_CACHE.maxsize)


def pubkey_from_bytes(data: bytes) -> bls.PublicKey:
    pk = _PUBKEY_CACHE.get(data)
    if pk is None:
        pk = _PUBKEY_CACHE.setdefault(data, bls.PublicKey(data))
    return pk


def validator_pubkey(state, index: int) -> bls.PublicKey:
    return pubkey_from_bytes(state.validators[index].pubkey)


def block_proposal_signature_set(
    state, signed_block, block_root: bytes | None, spec: ChainSpec, E
) -> bls.SignatureSet:
    block = signed_block.message
    epoch = compute_epoch_at_slot(block.slot, E)
    domain = get_domain(state, Domain.BEACON_PROPOSER, epoch, spec, E)
    root = block_root if block_root is not None else block.hash_tree_root()
    message = compute_signing_root(root, domain)
    return bls.SignatureSet.single(
        bls.Signature(signed_block.signature),
        validator_pubkey(state, block.proposer_index),
        message,
    )


def randao_signature_set(state, block, spec: ChainSpec, E) -> bls.SignatureSet:
    epoch = compute_epoch_at_slot(block.slot, E)
    domain = get_domain(state, Domain.RANDAO, epoch, spec, E)
    message = compute_signing_root(epoch.to_bytes(8, "little").ljust(32, b"\x00"), domain)
    return bls.SignatureSet.single(
        bls.Signature(block.body.randao_reveal),
        validator_pubkey(state, block.proposer_index),
        message,
    )


def block_header_signature_set(
    state, signed_header, spec: ChainSpec, E
) -> bls.SignatureSet:
    header = signed_header.message
    epoch = compute_epoch_at_slot(header.slot, E)
    domain = get_domain(state, Domain.BEACON_PROPOSER, epoch, spec, E)
    message = compute_signing_root(header.hash_tree_root(), domain)
    return bls.SignatureSet.single(
        bls.Signature(signed_header.signature),
        validator_pubkey(state, header.proposer_index),
        message,
    )


def indexed_attestation_signature_set(
    state, indexed_attestation, spec: ChainSpec, E
) -> bls.SignatureSet:
    domain = get_domain(
        state, Domain.BEACON_ATTESTER, indexed_attestation.data.target.epoch, spec, E
    )
    message = compute_signing_root(
        indexed_attestation.data.hash_tree_root(), domain
    )
    pubkeys = [
        validator_pubkey(state, i) for i in indexed_attestation.attesting_indices
    ]
    return bls.SignatureSet(
        signature=bls.Signature(indexed_attestation.signature),
        pubkeys=pubkeys,
        message=message,
    )


def exit_signature_set(state, signed_exit, spec: ChainSpec, E) -> bls.SignatureSet:
    from ..types.chain_spec import ForkName
    from ..types.containers import build_types

    exit_msg = signed_exit.message
    fork = build_types(E).fork_of_state(state)
    if fork >= ForkName.DENEB:
        # EIP-7044: exits are signed over the Capella fork domain forever.
        domain = spec.compute_domain_from_parts(
            Domain.VOLUNTARY_EXIT,
            spec.capella_fork_version,
            state.genesis_validators_root,
        )
    else:
        domain = get_domain(state, Domain.VOLUNTARY_EXIT, exit_msg.epoch, spec, E)
    message = compute_signing_root(exit_msg.hash_tree_root(), domain)
    return bls.SignatureSet.single(
        bls.Signature(signed_exit.signature),
        validator_pubkey(state, exit_msg.validator_index),
        message,
    )


def deposit_signature_message(deposit_data, spec: ChainSpec, E) -> bytes:
    """Deposits use the genesis-fork deposit domain and are verified
    individually (an invalid deposit signature skips the validator rather
    than invalidating the block)."""
    from ..types.containers import build_types

    t = build_types(E)
    msg = t.DepositMessage(
        pubkey=deposit_data.pubkey,
        withdrawal_credentials=deposit_data.withdrawal_credentials,
        amount=deposit_data.amount,
    )
    return compute_signing_root(msg.hash_tree_root(), spec.get_deposit_domain())


def selection_proof_signing_root(state, slot: int, spec: ChainSpec, E) -> bytes:
    """The ONE definition of the selection-proof message (validator.md
    get_slot_signature): shared by the VC's signer and the verifier so the
    recipe can never diverge."""
    domain = get_domain(
        state, Domain.SELECTION_PROOF, compute_epoch_at_slot(slot, E), spec, E
    )
    return compute_signing_root(
        int(slot).to_bytes(8, "little").ljust(32, b"\x00"), domain
    )


def selection_proof_signature_set(
    state, validator_index: int, slot: int, selection_proof, spec: ChainSpec, E
) -> bls.SignatureSet:
    return bls.SignatureSet.single(
        bls.Signature(selection_proof),
        validator_pubkey(state, validator_index),
        selection_proof_signing_root(state, slot, spec, E),
    )


def aggregate_and_proof_signature_set(
    state, signed_aggregate, spec: ChainSpec, E
) -> bls.SignatureSet:
    message_obj = signed_aggregate.message
    epoch = compute_epoch_at_slot(message_obj.aggregate.data.slot, E)
    domain = get_domain(state, Domain.AGGREGATE_AND_PROOF, epoch, spec, E)
    message = compute_signing_root(message_obj.hash_tree_root(), domain)
    return bls.SignatureSet.single(
        bls.Signature(signed_aggregate.signature),
        validator_pubkey(state, message_obj.aggregator_index),
        message,
    )
