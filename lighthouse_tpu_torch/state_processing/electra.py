"""Electra state transition: EIP-7251 (maxeb), EIP-7002 (EL-triggered

Counterpart of lighthouse_tpu/state_processing/electra.py, copied.

withdrawals), EIP-6110 (deposit receipts).

Reference parity targets: `upgrade_to_electra`
(consensus/state_processing/src/upgrade/electra.rs), the balance-churn
helpers on BeaconState (consensus/types/src/beacon_state.rs:2118-2240),
and the electra container set (types/src/{deposit_receipt,
execution_layer_withdrawal_request,pending_*}.rs). The reference snapshot
routes Electra epoch processing through the Altair path
(per_epoch_processing.rs:50); here the electra-specific stages
(pending-deposit/consolidation queues, compounding-aware effective
balances and withdrawals) are implemented per the electra spec so the
chain is functional end-to-end, not just typed.
"""

from __future__ import annotations

from ..types.chain_spec import FAR_FUTURE_EPOCH, ChainSpec
from ..utils.safe_arith import add_u64, safe_add, safe_sub, sub_u64
from .accessors import (
    compute_activation_exit_epoch,
    decrease_balance,
    mutable_validator,
    get_current_epoch,
    get_total_active_balance,
    increase_balance,
)

ETH1_ADDRESS_WITHDRAWAL_PREFIX = b"\x01"


# ---------------------------------------------------------------------------
# Credential / balance helpers (EIP-7251)
# ---------------------------------------------------------------------------


def is_compounding_withdrawal_credential(wc: bytes, spec: ChainSpec) -> bool:
    return wc[:1] == bytes([spec.compounding_withdrawal_prefix_byte])


def has_compounding_withdrawal_credential(validator, spec: ChainSpec) -> bool:
    return is_compounding_withdrawal_credential(
        validator.withdrawal_credentials, spec
    )


def has_execution_withdrawal_credential(validator, spec: ChainSpec) -> bool:
    return (
        has_compounding_withdrawal_credential(validator, spec)
        or validator.withdrawal_credentials[:1] == ETH1_ADDRESS_WITHDRAWAL_PREFIX
    )


def get_validator_max_effective_balance(validator, spec: ChainSpec) -> int:
    if has_compounding_withdrawal_credential(validator, spec):
        return spec.max_effective_balance_electra
    return spec.min_activation_balance


def get_active_balance(state, index: int, spec: ChainSpec) -> int:
    return min(
        state.balances[index],
        get_validator_max_effective_balance(state.validators[index], spec),
    )


def get_pending_balance_to_withdraw(state, index: int) -> int:
    return sum(
        w.amount for w in state.pending_partial_withdrawals if w.index == index
    )


# ---------------------------------------------------------------------------
# Balance churn (EIP-7251 weight-denominated churn)
# ---------------------------------------------------------------------------


def get_balance_churn_limit(state, spec: ChainSpec, E) -> int:
    churn = max(
        spec.min_per_epoch_churn_limit_electra,
        get_total_active_balance(state, E) // spec.churn_limit_quotient,
    )
    return churn - churn % E.EFFECTIVE_BALANCE_INCREMENT


def get_activation_exit_churn_limit(state, spec: ChainSpec, E) -> int:
    return min(
        spec.max_per_epoch_activation_exit_churn_limit,
        get_balance_churn_limit(state, spec, E),
    )


def get_consolidation_churn_limit(state, spec: ChainSpec, E) -> int:
    return get_balance_churn_limit(state, spec, E) - get_activation_exit_churn_limit(
        state, spec, E
    )


def compute_exit_epoch_and_update_churn(state, exit_balance: int, spec, E) -> int:
    """beacon_state.rs:2197-2240 / electra spec: weight-based exit queue."""
    earliest_exit_epoch = max(
        state.earliest_exit_epoch,
        compute_activation_exit_epoch(get_current_epoch(state, E), E),
    )
    per_epoch_churn = get_activation_exit_churn_limit(state, spec, E)
    if state.earliest_exit_epoch < earliest_exit_epoch:
        exit_balance_to_consume = per_epoch_churn
    else:
        exit_balance_to_consume = state.exit_balance_to_consume

    if exit_balance > exit_balance_to_consume:
        balance_to_process = exit_balance - exit_balance_to_consume
        additional_epochs = (balance_to_process - 1) // per_epoch_churn + 1
        earliest_exit_epoch += additional_epochs
        exit_balance_to_consume += additional_epochs * per_epoch_churn

    state.exit_balance_to_consume = exit_balance_to_consume - exit_balance
    state.earliest_exit_epoch = earliest_exit_epoch
    return earliest_exit_epoch


def compute_consolidation_epoch_and_update_churn(
    state, consolidation_balance: int, spec, E
) -> int:
    earliest = max(
        state.earliest_consolidation_epoch,
        compute_activation_exit_epoch(get_current_epoch(state, E), E),
    )
    per_epoch_churn = get_consolidation_churn_limit(state, spec, E)
    if state.earliest_consolidation_epoch < earliest:
        balance_to_consume = per_epoch_churn
    else:
        balance_to_consume = state.consolidation_balance_to_consume

    if consolidation_balance > balance_to_consume:
        balance_to_process = consolidation_balance - balance_to_consume
        additional_epochs = (balance_to_process - 1) // per_epoch_churn + 1
        earliest += additional_epochs
        balance_to_consume += additional_epochs * per_epoch_churn

    state.consolidation_balance_to_consume = (
        balance_to_consume - consolidation_balance
    )
    state.earliest_consolidation_epoch = earliest
    return earliest


def initiate_validator_exit_electra(state, index: int, spec: ChainSpec, E):
    if state.validators[index].exit_epoch != FAR_FUTURE_EPOCH:
        return
    exit_queue_epoch = compute_exit_epoch_and_update_churn(
        state, state.validators[index].effective_balance, spec, E
    )
    v = mutable_validator(state, index)
    v.exit_epoch = exit_queue_epoch
    v.withdrawable_epoch = (
        exit_queue_epoch + spec.min_validator_withdrawability_delay
    )


# ---------------------------------------------------------------------------
# Compounding transitions (used by the upgrade + consolidations)
# ---------------------------------------------------------------------------


def queue_excess_active_balance(state, index: int, spec: ChainSpec, E):
    from ..types.containers import build_types

    balance = state.balances[index]
    if balance > spec.min_activation_balance:
        excess = safe_sub(balance, spec.min_activation_balance)
        state.balances[index] = spec.min_activation_balance
        state.pending_balance_deposits.append(
            build_types(E).PendingBalanceDeposit(index=index, amount=excess)
        )


def queue_entire_balance_and_reset_validator(state, index: int, spec: ChainSpec, E):
    from ..types.containers import build_types

    balance = state.balances[index]
    state.balances[index] = 0
    v = mutable_validator(state, index)
    v.effective_balance = 0
    v.activation_eligibility_epoch = FAR_FUTURE_EPOCH
    if balance > 0:
        state.pending_balance_deposits.append(
            build_types(E).PendingBalanceDeposit(index=index, amount=balance)
        )


def switch_to_compounding_validator(state, index: int, spec: ChainSpec, E):
    if has_execution_withdrawal_credential(state.validators[index], spec):
        v = mutable_validator(state, index)
        v.withdrawal_credentials = (
            bytes([spec.compounding_withdrawal_prefix_byte])
            + v.withdrawal_credentials[1:]
        )
        queue_excess_active_balance(state, index, spec, E)


# ---------------------------------------------------------------------------
# Block operations
# ---------------------------------------------------------------------------


def process_deposit_receipt(state, receipt, spec: ChainSpec, E):
    """EIP-6110: in-payload deposits; the first receipt pins the start
    index so eth1-bridge deposits can be phased out."""
    from .per_block import apply_deposit

    if state.deposit_receipts_start_index == spec.unset_deposit_receipts_start_index:
        state.deposit_receipts_start_index = receipt.index
    apply_deposit(
        state,
        _receipt_as_deposit_data(receipt, E),
        spec,
        E,
    )


def _receipt_as_deposit_data(receipt, E):
    from ..types.containers import build_types

    t = build_types(E)
    return t.DepositData(
        pubkey=receipt.pubkey,
        withdrawal_credentials=receipt.withdrawal_credentials,
        amount=receipt.amount,
        signature=receipt.signature,
    )


def process_execution_layer_withdrawal_request(state, request, spec: ChainSpec, E):
    """EIP-7002: EL-triggered (full or partial) withdrawals. Invalid
    requests are silently ignored (spec: no block failure)."""
    from .accessors import is_active_validator

    amount = request.amount
    is_full_exit = amount == spec.full_exit_request_amount
    if (
        len(state.pending_partial_withdrawals) >= E.PENDING_PARTIAL_WITHDRAWALS_LIMIT
        and not is_full_exit
    ):
        return

    index = _index_by_pubkey(state, request.validator_pubkey)
    if index is None:
        return
    v = state.validators[index]
    if not has_execution_withdrawal_credential(v, spec):
        return
    if v.withdrawal_credentials[12:] != bytes(request.source_address):
        return
    current_epoch = get_current_epoch(state, E)
    if not is_active_validator(v, current_epoch):
        return
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    if current_epoch < v.activation_epoch + spec.shard_committee_period:
        return

    pending_balance_to_withdraw = get_pending_balance_to_withdraw(state, index)
    if is_full_exit:
        if pending_balance_to_withdraw == 0:
            initiate_validator_exit_electra(state, index, spec, E)
        return

    balance = state.balances[index]
    has_sufficient_effective_balance = (
        v.effective_balance >= spec.min_activation_balance
    )
    has_excess_balance = (
        balance > spec.min_activation_balance + pending_balance_to_withdraw
    )
    if (
        has_compounding_withdrawal_credential(v, spec)
        and has_sufficient_effective_balance
        and has_excess_balance
    ):
        from ..types.containers import build_types

        to_withdraw = min(
            # guarded by has_excess_balance above
            safe_sub(
                safe_sub(balance, spec.min_activation_balance),
                pending_balance_to_withdraw,
            ),
            amount,
        )
        exit_queue_epoch = compute_exit_epoch_and_update_churn(
            state, to_withdraw, spec, E
        )
        withdrawable_epoch = (
            exit_queue_epoch + spec.min_validator_withdrawability_delay
        )
        state.pending_partial_withdrawals.append(
            build_types(E).PendingPartialWithdrawal(
                index=index,
                amount=to_withdraw,
                withdrawable_epoch=withdrawable_epoch,
            )
        )


def _index_by_pubkey(state, pubkey: bytes):
    from .per_block import _validator_index_by_pubkey

    return _validator_index_by_pubkey(state, bytes(pubkey))


# ---------------------------------------------------------------------------
# Withdrawals (compounding-aware sweep + pending partials)
# ---------------------------------------------------------------------------


def is_fully_withdrawable_validator_electra(validator, balance, epoch, spec) -> bool:
    return (
        has_execution_withdrawal_credential(validator, spec)
        and validator.withdrawable_epoch <= epoch
        and balance > 0
    )


def is_partially_withdrawable_validator_electra(validator, balance, spec) -> bool:
    max_eb = get_validator_max_effective_balance(validator, spec)
    return (
        has_execution_withdrawal_credential(validator, spec)
        and validator.effective_balance == max_eb
        and balance > max_eb
    )


def get_expected_withdrawals_electra(state, spec: ChainSpec, E):
    """Returns (withdrawals, processed_partial_withdrawals_count)."""
    from ..types.containers import build_types

    t = build_types(E)
    epoch = get_current_epoch(state, E)
    withdrawal_index = state.next_withdrawal_index
    withdrawals = []

    # stage 1: matured pending partial withdrawals (EIP-7002 queue).
    # processed_count counts every CONSUMED queue entry (spec
    # processed_partial_withdrawals_count) — matured-but-skipped entries
    # (exited validator, insufficient balance) are consumed without
    # producing a withdrawal, and process_withdrawals pops exactly this
    # many off the queue front.
    processed_count = 0
    for w in state.pending_partial_withdrawals:
        if (
            w.withdrawable_epoch > epoch
            or len(withdrawals) == E.MAX_PENDING_PARTIALS_PER_WITHDRAWALS_SWEEP
        ):
            break
        v = state.validators[w.index]
        if (
            v.exit_epoch == FAR_FUTURE_EPOCH
            and v.effective_balance >= spec.min_activation_balance
        ):
            # spec: withdrawals already produced for this validator in
            # THIS sweep reduce the balance the excess test sees — each
            # prior entry was capped at the then-remaining excess, so
            # the running sum never exceeds balance - min_activation
            balance = safe_sub(
                state.balances[w.index],
                sum(p.amount for p in withdrawals if p.validator_index == w.index),
            )
            if balance > spec.min_activation_balance:
                withdrawable = min(
                    safe_sub(balance, spec.min_activation_balance),
                    w.amount,
                )
                withdrawals.append(
                    t.Withdrawal(
                        index=withdrawal_index,
                        validator_index=w.index,
                        address=v.withdrawal_credentials[12:],
                        amount=withdrawable,
                    )
                )
                withdrawal_index += 1
        processed_count += 1
    stage1_produced = len(withdrawals)

    # stage 2: the bounded sweep, compounding-aware
    validator_index = state.next_withdrawal_validator_index
    n = len(state.validators)
    bound = min(n, E.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP)
    for _ in range(bound):
        v = state.validators[validator_index]
        balance = state.balances[validator_index]
        # partially-withdrawn amounts in stage 1 reduce the visible balance
        # (stage 1 caps each entry at the then-remaining excess, so the
        # per-validator sum never exceeds balance - min_activation)
        balance = safe_sub(
            balance,
            sum(
                w.amount
                for w in withdrawals[:stage1_produced]
                if w.validator_index == validator_index
            ),
        )
        if is_fully_withdrawable_validator_electra(v, balance, epoch, spec):
            withdrawals.append(
                t.Withdrawal(
                    index=withdrawal_index,
                    validator_index=validator_index,
                    address=v.withdrawal_credentials[12:],
                    amount=balance,
                )
            )
            withdrawal_index += 1
        elif is_partially_withdrawable_validator_electra(v, balance, spec):
            withdrawals.append(
                t.Withdrawal(
                    index=withdrawal_index,
                    validator_index=validator_index,
                    address=v.withdrawal_credentials[12:],
                    # guarded by is_partially_withdrawable (balance > maxeb)
                    amount=safe_sub(
                        balance, get_validator_max_effective_balance(v, spec)
                    ),
                )
            )
            withdrawal_index += 1
        if len(withdrawals) == E.MAX_WITHDRAWALS_PER_PAYLOAD:
            break
        validator_index = (validator_index + 1) % n
    return withdrawals, processed_count


# ---------------------------------------------------------------------------
# Epoch processing additions
# ---------------------------------------------------------------------------


def process_pending_balance_deposits(state, spec: ChainSpec, E):
    available = state.deposit_balance_to_consume + get_activation_exit_churn_limit(
        state, spec, E
    )
    processed = 0
    next_index = 0
    for dep in state.pending_balance_deposits:
        if processed + dep.amount > available:
            break
        increase_balance(state, dep.index, dep.amount)
        processed += dep.amount
        next_index += 1
    state.pending_balance_deposits = state.pending_balance_deposits[next_index:]
    if not state.pending_balance_deposits:
        state.deposit_balance_to_consume = 0
    else:
        state.deposit_balance_to_consume = available - processed


def process_pending_consolidations(state, spec: ChainSpec, E):
    epoch = get_current_epoch(state, E)
    next_index = 0
    for c in state.pending_consolidations:
        source = state.validators[c.source_index]
        if source.slashed:
            next_index += 1
            continue
        if source.withdrawable_epoch > epoch:
            break
        active_balance = get_active_balance(state, c.source_index, spec)
        decrease_balance(state, c.source_index, active_balance)
        increase_balance(state, c.target_index, active_balance)
        next_index += 1
    state.pending_consolidations = state.pending_consolidations[next_index:]


def process_effective_balance_updates_electra(state, spec: ChainSpec, E, arrays=None):
    """EIP-7251 hysteresis sweep, vectorized: stale detection is one
    masked pass over the resident columns (compounding-aware max-eb from
    the withdrawal-credential prefix byte); only the out-of-band
    validators (a handful per epoch in steady state) get object
    writebacks, drained as one dirty-index batch by the next columns
    refresh. The per-validator loop is retained for plain-list states."""
    import numpy as np

    hysteresis_increment = E.EFFECTIVE_BALANCE_INCREMENT // E.HYSTERESIS_QUOTIENT
    down = hysteresis_increment * E.HYSTERESIS_DOWNWARD_MULTIPLIER
    up = hysteresis_increment * E.HYSTERESIS_UPWARD_MULTIPLIER
    if arrays is not None:
        balances = arrays.load_balances(state)
        effective = arrays.effective_balance
        if arrays.columns is not None:
            compounding = (
                arrays.columns.withdrawal_credentials[:, 0]
                == spec.compounding_withdrawal_prefix_byte
            )
        else:
            compounding = np.fromiter(
                (
                    has_compounding_withdrawal_credential(v, spec)
                    for v in state.validators
                ),
                dtype=bool,
                count=arrays.n,
            )
        max_eb = np.where(
            compounding,
            np.uint64(spec.max_effective_balance_electra),
            np.uint64(spec.min_activation_balance),
        )
        stale = (add_u64(balances, np.uint64(down)) < effective) | (
            add_u64(effective, np.uint64(up)) < balances
        )
        if not stale.any():
            return
        increment = np.uint64(E.EFFECTIVE_BALANCE_INCREMENT)
        new_eff = np.minimum(sub_u64(balances, balances % increment), max_eb)
        stale_idx = np.nonzero(stale)[0]
        vs = state.validators
        if hasattr(vs, "set_fields_bulk"):
            from ..metrics import inc_counter

            vs.set_fields_bulk(
                stale_idx.tolist(),
                "effective_balance",
                new_eff[stale_idx].tolist(),
            )
            inc_counter(
                "registry_columns_row_writebacks_total",
                int(stale_idx.size),
                field="validators",
            )
        else:
            for i in stale_idx:
                mutable_validator(state, int(i)).effective_balance = int(
                    new_eff[i]
                )
        if arrays.columns is None:
            arrays.write_snapshot_rows(
                "effective_balance", stale_idx, new_eff[stale_idx]
            )
        return
    for index, v in enumerate(state.validators):
        balance = state.balances[index]
        max_eb = get_validator_max_effective_balance(v, spec)
        if (
            safe_add(balance, down) < v.effective_balance
            or safe_add(v.effective_balance, up) < balance
        ):
            mutable_validator(state, index).effective_balance = min(
                safe_sub(balance, balance % E.EFFECTIVE_BALANCE_INCREMENT),
                max_eb,
            )


# ---------------------------------------------------------------------------
# Upgrade (upgrade/electra.rs)
# ---------------------------------------------------------------------------


def upgrade_to_electra(state, spec: ChainSpec, E):
    from ..types.containers import build_types
    from .upgrades import _bump_fork, _swap_class

    t = build_types(E)
    epoch = get_current_epoch(state, E)

    exit_epochs = [
        v.exit_epoch
        for v in state.validators
        if v.exit_epoch != FAR_FUTURE_EPOCH
    ]
    earliest_exit_epoch = (max(exit_epochs) if exit_epochs else epoch) + 1

    old_header = state.latest_execution_payload_header
    new_header = t.ExecutionPayloadHeaderElectra(
        **{f: getattr(old_header, f) for f in type(old_header)._fields},
        deposit_receipts_root=b"\x00" * 32,
        withdrawal_requests_root=b"\x00" * 32,
    )
    _swap_class(
        state,
        t.BeaconStateElectra,
        dict(
            latest_execution_payload_header=new_header,
            deposit_receipts_start_index=spec.unset_deposit_receipts_start_index,
            deposit_balance_to_consume=0,
            exit_balance_to_consume=0,
            earliest_exit_epoch=earliest_exit_epoch,
            consolidation_balance_to_consume=0,
            earliest_consolidation_epoch=compute_activation_exit_epoch(epoch, E),
            pending_balance_deposits=[],
            pending_partial_withdrawals=[],
            pending_consolidations=[],
        ),
    )
    _bump_fork(state, t, spec.electra_fork_version, epoch)
    state.exit_balance_to_consume = get_activation_exit_churn_limit(state, spec, E)
    state.consolidation_balance_to_consume = get_consolidation_churn_limit(
        state, spec, E
    )

    # queue pre-activation validators' entire balances (sorted by
    # eligibility epoch then index), then excess balances of early
    # compounding adopters (upgrade/electra.rs:103-132)
    pre_activation = sorted(
        (
            i
            for i, v in enumerate(state.validators)
            if v.activation_epoch == FAR_FUTURE_EPOCH
        ),
        key=lambda i: (state.validators[i].activation_eligibility_epoch, i),
    )
    for index in pre_activation:
        queue_entire_balance_and_reset_validator(state, index, spec, E)
    for index, v in enumerate(state.validators):
        if has_compounding_withdrawal_credential(v, spec):
            queue_excess_active_balance(state, index, spec, E)
