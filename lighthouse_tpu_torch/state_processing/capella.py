"""Capella: withdrawals sweep + BLS-to-execution credential changes.

Counterpart of lighthouse_tpu/state_processing/capella.py, copied;
Electra's pending partial withdrawals raise NotImplementedError (electra.py
is not ported yet).

Mirrors capella/beacon-chain.md process_withdrawals /
process_bls_to_execution_change (reference per_block_processing.rs capella
arms + signature_sets.rs bls_execution_change_signature_set).
"""

from __future__ import annotations

from ..types.chain_spec import ChainSpec, Domain, compute_signing_root
from ..utils.safe_arith import safe_sub
from .accessors import (
    decrease_balance,
    electra_not_ported,
    get_current_epoch,
    mutable_validator,
)

BLS_WITHDRAWAL_PREFIX = b"\x00"
ETH1_ADDRESS_WITHDRAWAL_PREFIX = b"\x01"


def has_eth1_withdrawal_credential(validator) -> bool:
    return validator.withdrawal_credentials[:1] == ETH1_ADDRESS_WITHDRAWAL_PREFIX


def is_fully_withdrawable_validator(validator, balance: int, epoch: int) -> bool:
    return (
        has_eth1_withdrawal_credential(validator)
        and validator.withdrawable_epoch <= epoch
        and balance > 0
    )


def is_partially_withdrawable_validator(validator, balance: int, E) -> bool:
    has_max_eb = validator.effective_balance == E.MAX_EFFECTIVE_BALANCE
    has_excess = balance > E.MAX_EFFECTIVE_BALANCE
    return has_eth1_withdrawal_credential(validator) and has_max_eb and has_excess


def get_expected_withdrawals(state, E) -> list:
    """The bounded validator sweep from next_withdrawal_validator_index."""
    from ..types.containers import build_types

    t = build_types(E)
    epoch = get_current_epoch(state, E)
    withdrawal_index = state.next_withdrawal_index
    validator_index = state.next_withdrawal_validator_index
    withdrawals = []
    n = len(state.validators)
    bound = min(n, E.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP)
    for _ in range(bound):
        validator = state.validators[validator_index]
        balance = state.balances[validator_index]
        if is_fully_withdrawable_validator(validator, balance, epoch):
            withdrawals.append(
                t.Withdrawal(
                    index=withdrawal_index,
                    validator_index=validator_index,
                    address=validator.withdrawal_credentials[12:],
                    amount=balance,
                )
            )
            withdrawal_index += 1
        elif is_partially_withdrawable_validator(validator, balance, E):
            withdrawals.append(
                t.Withdrawal(
                    index=withdrawal_index,
                    validator_index=validator_index,
                    address=validator.withdrawal_credentials[12:],
                    # guarded by is_partially_withdrawable (balance > maxeb)
                    amount=safe_sub(balance, E.MAX_EFFECTIVE_BALANCE),
                )
            )
            withdrawal_index += 1
        if len(withdrawals) == E.MAX_WITHDRAWALS_PER_PAYLOAD:
            break
        validator_index = (validator_index + 1) % n
    return withdrawals


def process_withdrawals(state, execution_payload, E, spec: ChainSpec | None = None):
    from .per_block import BlockProcessingError

    partial_count = 0
    if hasattr(state, "pending_partial_withdrawals"):
        # Electra: matured pending partials lead the sweep and are popped
        electra_not_ported("process_withdrawals")
    else:
        expected = get_expected_withdrawals(state, E)
    actual = list(execution_payload.withdrawals)
    if len(actual) != len(expected):
        raise BlockProcessingError(
            f"withdrawals: expected {len(expected)}, payload has {len(actual)}"
        )
    for got, want in zip(actual, expected):
        if got != want:
            raise BlockProcessingError("withdrawals: mismatch with expected sweep")
        decrease_balance(state, want.validator_index, want.amount)

    if partial_count:
        state.pending_partial_withdrawals = state.pending_partial_withdrawals[
            partial_count:
        ]
    if expected:
        state.next_withdrawal_index = expected[-1].index + 1
    n = len(state.validators)
    if len(expected) == E.MAX_WITHDRAWALS_PER_PAYLOAD:
        # Full payload: resume after the last withdrawn validator.
        state.next_withdrawal_validator_index = (
            expected[-1].validator_index + 1
        ) % n
    else:
        # Sweep exhausted its bound: advance by the sweep length.
        state.next_withdrawal_validator_index = (
            state.next_withdrawal_validator_index
            + E.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP
        ) % n


def bls_to_execution_change_signature_set(state, signed_change, spec: ChainSpec, E):
    """Signed with the GENESIS fork version regardless of current fork
    (capella spec: compute_domain with genesis_fork_version +
    genesis_validators_root)."""
    from ..crypto import bls

    change = signed_change.message
    domain = spec.compute_domain_from_parts(
        Domain.BLS_TO_EXECUTION_CHANGE,
        spec.genesis_fork_version,
        state.genesis_validators_root,
    )
    message = compute_signing_root(change.hash_tree_root(), domain)
    return bls.SignatureSet.single(
        bls.Signature(signed_change.signature),
        bls.PublicKey(change.from_bls_pubkey),
        message,
    )


def process_bls_to_execution_change(
    state, signed_change, spec: ChainSpec, E, verify_signatures: bool
):
    import hashlib

    from .per_block import BlockProcessingError

    change = signed_change.message
    if change.validator_index >= len(state.validators):
        raise BlockProcessingError("bls change: unknown validator")
    validator = state.validators[change.validator_index]
    if validator.withdrawal_credentials[:1] != BLS_WITHDRAWAL_PREFIX:
        raise BlockProcessingError("bls change: not a BLS credential")
    if (
        validator.withdrawal_credentials[1:]
        != hashlib.sha256(bytes(change.from_bls_pubkey)).digest()[1:]
    ):
        raise BlockProcessingError("bls change: pubkey hash mismatch")
    if verify_signatures and not bls_to_execution_change_signature_set(
        state, signed_change, spec, E
    ).verify():
        raise BlockProcessingError("bls change: bad signature")
    mutable_validator(state, change.validator_index).withdrawal_credentials = (
        ETH1_ADDRESS_WITHDRAWAL_PREFIX
        + b"\x00" * 11
        + bytes(change.to_execution_address)
    )
