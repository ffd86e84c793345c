# lint: allow-file(safe-arith) -- retained scalar oracle: exact Python-int spec math, kept verbatim for differential testing
"""Per-validator reference epoch transition — the retained oracle.

Counterpart of lighthouse_tpu/state_processing/epoch_reference.py, copied.

A deliberately scalar, spec-shaped translation of the epoch sweeps (one
Python loop iteration per validator, exactly the consensus-specs
pseudocode / the naive reading of the reference's single_pass.rs): no
numpy, no resident columns, no snapshot arrays. Its job is
differential testing: tests/test_torch_electra.py and
tests/test_torch_state_transition.py drive the resident-columns
transition and this oracle over identical states and assert bit-identical
results across forks and churn.

Keep it boring. Any cleverness added here erodes its value as an oracle.
"""

from __future__ import annotations

from ..types.chain_spec import FAR_FUTURE_EPOCH, GENESIS_EPOCH, ChainSpec, ForkName
from .accessors import (
    compute_activation_exit_epoch,
    decrease_balance,
    get_current_epoch,
    get_previous_epoch,
    increase_balance,
    initiate_validator_exit,
    int_sqrt,
    invalidate_caches,
    is_active_validator,
    mutable_validator,
)
from .altair import (
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    has_flag,
    process_historical_summaries_update,
    process_participation_flag_updates,
    process_sync_committee_updates,
)
from .per_epoch import (
    get_finality_delay,
    process_eth1_data_reset,
    process_historical_roots_update,
    process_participation_record_updates,
    process_randao_mixes_reset,
    process_rewards_and_penalties_reference,
    process_slashings_reference,
    process_slashings_reset,
    weigh_justification_and_finalization,
)


def _eligible(state, i: int, previous: int) -> bool:
    v = state.validators[i]
    return is_active_validator(v, previous) or (
        v.slashed and previous + 1 < v.withdrawable_epoch
    )


def _total_active_balance_scalar(state, E) -> int:
    current = get_current_epoch(state, E)
    total = sum(
        v.effective_balance
        for v in state.validators
        if is_active_validator(v, current)
    )
    return max(total, E.EFFECTIVE_BALANCE_INCREMENT)


def _unslashed_participating_balance_scalar(
    state, flag_index: int, epoch: int, E
) -> int:
    participation = (
        state.previous_epoch_participation
        if epoch == get_previous_epoch(state, E)
        else state.current_epoch_participation
    )
    total = sum(
        v.effective_balance
        for i, v in enumerate(state.validators)
        if is_active_validator(v, epoch)
        and not v.slashed
        and has_flag(participation[i], flag_index)
    )
    return max(total, E.EFFECTIVE_BALANCE_INCREMENT)


def process_justification_and_finalization_scalar(state, E):
    if get_current_epoch(state, E) <= GENESIS_EPOCH + 1:
        return
    previous = get_previous_epoch(state, E)
    current = get_current_epoch(state, E)
    weigh_justification_and_finalization(
        state,
        _total_active_balance_scalar(state, E),
        _unslashed_participating_balance_scalar(
            state, TIMELY_TARGET_FLAG_INDEX, previous, E
        ),
        _unslashed_participating_balance_scalar(
            state, TIMELY_TARGET_FLAG_INDEX, current, E
        ),
        E,
    )


def process_inactivity_updates_scalar(state, spec: ChainSpec, E):
    if get_current_epoch(state, E) == GENESIS_EPOCH:
        return
    previous = get_previous_epoch(state, E)
    in_leak = get_finality_delay(state, E) > E.MIN_EPOCHS_TO_INACTIVITY_PENALTY
    participation = state.previous_epoch_participation
    for i, v in enumerate(state.validators):
        if not _eligible(state, i, previous):
            continue
        participated = (
            is_active_validator(v, previous)
            and not v.slashed
            and has_flag(participation[i], TIMELY_TARGET_FLAG_INDEX)
        )
        score = state.inactivity_scores[i]
        if participated:
            score -= min(1, score)
        else:
            score += spec.inactivity_score_bias
        if not in_leak:
            score -= min(spec.inactivity_score_recovery_rate, score)
        if score != state.inactivity_scores[i]:
            state.inactivity_scores[i] = score


def process_rewards_and_penalties_altair_scalar(
    state, spec: ChainSpec, E, fork: ForkName
):
    """get_flag_index_deltas + get_inactivity_penalty_deltas, one
    validator at a time."""
    if get_current_epoch(state, E) == GENESIS_EPOCH:
        return
    previous = get_previous_epoch(state, E)
    total_active = _total_active_balance_scalar(state, E)
    base_reward_per_increment = (
        E.EFFECTIVE_BALANCE_INCREMENT
        * E.BASE_REWARD_FACTOR
        // int_sqrt(total_active)
    )
    total_active_increments = total_active // E.EFFECTIVE_BALANCE_INCREMENT
    in_leak = get_finality_delay(state, E) > E.MIN_EPOCHS_TO_INACTIVITY_PENALTY
    upb_increments = [
        _unslashed_participating_balance_scalar(state, f, previous, E)
        // E.EFFECTIVE_BALANCE_INCREMENT
        for f in range(len(PARTICIPATION_FLAG_WEIGHTS))
    ]
    quotient = (
        E.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX
        if fork >= ForkName.BELLATRIX
        else E.INACTIVITY_PENALTY_QUOTIENT_ALTAIR
    )
    participation = state.previous_epoch_participation
    for i, v in enumerate(state.validators):
        if not _eligible(state, i, previous):
            continue
        base_reward = (
            v.effective_balance // E.EFFECTIVE_BALANCE_INCREMENT
        ) * base_reward_per_increment
        reward = 0
        penalty = 0
        active_unslashed = is_active_validator(v, previous) and not v.slashed
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            if active_unslashed and has_flag(participation[i], flag_index):
                if not in_leak:
                    reward += (
                        base_reward * weight * upb_increments[flag_index]
                        // (total_active_increments * WEIGHT_DENOMINATOR)
                    )
            elif flag_index != TIMELY_HEAD_FLAG_INDEX:
                penalty += base_reward * weight // WEIGHT_DENOMINATOR
        if not (
            active_unslashed
            and has_flag(participation[i], TIMELY_TARGET_FLAG_INDEX)
        ):
            penalty += (
                v.effective_balance * state.inactivity_scores[i]
                // (spec.inactivity_score_bias * quotient)
            )
        increase_balance(state, i, reward)
        decrease_balance(state, i, penalty)


def process_registry_updates_scalar(state, spec: ChainSpec, E):
    from ..types.containers import build_types

    fork = build_types(E).fork_of_state(state)
    electra = fork >= ForkName.ELECTRA
    current = get_current_epoch(state, E)
    for i, v in enumerate(state.validators):
        if v.activation_eligibility_epoch == FAR_FUTURE_EPOCH and (
            v.effective_balance >= spec.min_activation_balance
            if electra
            else v.effective_balance == E.MAX_EFFECTIVE_BALANCE
        ):
            mutable_validator(state, i).activation_eligibility_epoch = (
                current + 1
            )
        if (
            is_active_validator(state.validators[i], current)
            and state.validators[i].effective_balance <= spec.ejection_balance
        ):
            initiate_validator_exit(state, i, spec, E)
    queue = sorted(
        (
            i
            for i, v in enumerate(state.validators)
            if v.activation_eligibility_epoch
            <= state.finalized_checkpoint.epoch
            and v.activation_epoch == FAR_FUTURE_EPOCH
        ),
        key=lambda i: (
            state.validators[i].activation_eligibility_epoch,
            i,
        ),
    )
    if electra:
        limit = len(queue)
    else:
        active_count = sum(
            1
            for v in state.validators
            if is_active_validator(v, current)
        )
        limit = spec.activation_churn_limit(active_count, fork)
    target = compute_activation_exit_epoch(current, E)
    for i in queue[:limit]:
        mutable_validator(state, i).activation_epoch = target


def process_slashings_altair_scalar(state, E, fork: ForkName):
    epoch = get_current_epoch(state, E)
    total_balance = _total_active_balance_scalar(state, E)
    multiplier = (
        E.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX
        if fork >= ForkName.BELLATRIX
        else E.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR
    )
    adjusted = min(sum(state.slashings) * multiplier, total_balance)
    increment = E.EFFECTIVE_BALANCE_INCREMENT
    target = epoch + E.EPOCHS_PER_SLASHINGS_VECTOR // 2
    for i, v in enumerate(state.validators):
        if v.slashed and v.withdrawable_epoch == target:
            if fork >= ForkName.ELECTRA:
                per_increment = adjusted // (total_balance // increment)
                penalty = per_increment * (v.effective_balance // increment)
            else:
                penalty = (
                    v.effective_balance // increment * adjusted
                    // total_balance * increment
                )
            decrease_balance(state, i, penalty)


def process_effective_balance_updates_scalar(state, spec: ChainSpec, E, fork):
    from .electra import get_validator_max_effective_balance

    hysteresis_increment = (
        E.EFFECTIVE_BALANCE_INCREMENT // E.HYSTERESIS_QUOTIENT
    )
    down = hysteresis_increment * E.HYSTERESIS_DOWNWARD_MULTIPLIER
    up = hysteresis_increment * E.HYSTERESIS_UPWARD_MULTIPLIER
    for i, v in enumerate(state.validators):
        balance = state.balances[i]
        max_eb = (
            get_validator_max_effective_balance(v, spec)
            if fork >= ForkName.ELECTRA
            else E.MAX_EFFECTIVE_BALANCE
        )
        if balance + down < v.effective_balance or v.effective_balance + up < balance:
            mutable_validator(state, i).effective_balance = min(
                balance - balance % E.EFFECTIVE_BALANCE_INCREMENT, max_eb
            )


def process_epoch_reference(state, spec: ChainSpec, E):
    """The full per-validator epoch transition (all forks)."""
    from ..types.containers import build_types

    fork = build_types(E).fork_of_state(state)
    if fork < ForkName.ALTAIR:
        _process_epoch_phase0_reference(state, spec, E)
        return
    process_justification_and_finalization_scalar(state, E)
    process_inactivity_updates_scalar(state, spec, E)
    process_rewards_and_penalties_altair_scalar(state, spec, E, fork)
    process_registry_updates_scalar(state, spec, E)
    process_slashings_altair_scalar(state, E, fork)
    process_eth1_data_reset(state, E)
    if fork >= ForkName.ELECTRA:
        from .electra import (
            process_effective_balance_updates_electra,
            process_pending_balance_deposits,
            process_pending_consolidations,
        )

        process_pending_balance_deposits(state, spec, E)
        process_pending_consolidations(state, spec, E)
        # arrays=None: the retained per-validator loop
        process_effective_balance_updates_electra(state, spec, E)
    else:
        process_effective_balance_updates_scalar(state, spec, E, fork)
    process_slashings_reset(state, E)
    process_randao_mixes_reset(state, E)
    if fork >= ForkName.CAPELLA:
        process_historical_summaries_update(state, E)
    else:
        process_historical_roots_update(state, E)
    process_participation_flag_updates(state, E)
    process_sync_committee_updates(state, E)
    invalidate_caches(state)


def _process_epoch_phase0_reference(state, spec: ChainSpec, E):
    from .per_epoch import process_justification_and_finalization

    process_justification_and_finalization(state, E)
    process_rewards_and_penalties_reference(state, spec, E)
    process_registry_updates_scalar(state, spec, E)
    process_slashings_reference(state, E)
    process_eth1_data_reset(state, E)
    process_effective_balance_updates_scalar(
        state, spec, E, ForkName.PHASE0
    )
    process_slashings_reset(state, E)
    process_randao_mixes_reset(state, E)
    process_historical_roots_update(state, E)
    process_participation_record_updates(state, E)
    invalidate_caches(state)
