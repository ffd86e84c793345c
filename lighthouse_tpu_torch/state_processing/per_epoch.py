"""Epoch processing (phase0 base path).

Counterpart of lighthouse_tpu/state_processing/per_epoch.py, copied; a
state at or after Electra raises NotImplementedError (electra.py is not
ported yet).

Mirrors consensus/state_processing/src/per_epoch_processing.rs:44-52 (phase0
multi-pass with ValidatorStatuses; Altair+ gets the fused single-pass later).
The per-validator sweeps are structured as index sets + whole-registry loops
so the device (vectorized) epoch path can slot in behind the same functions.
"""

from __future__ import annotations

from ..types.chain_spec import FAR_FUTURE_EPOCH, GENESIS_EPOCH, ChainSpec
from ..utils.safe_arith import (
    add_u64,
    div_u64,
    mul_u64,
    safe_div,
    safe_mul,
    sub_u64,
    sub_u64_saturating,
)
from .accessors import (
    compute_activation_exit_epoch,
    mutable_validator,
    decrease_balance,
    get_active_validator_indices,
    get_attesting_indices,
    get_block_root,
    get_block_root_at_slot,
    get_current_epoch,
    get_previous_epoch,
    get_randao_mix,
    get_total_active_balance,
    get_total_balance,
    get_validator_churn_limit,
    increase_balance,
    initiate_validator_exit,
    int_sqrt,
    invalidate_caches,
    is_active_validator,
    is_eligible_for_activation,
    is_eligible_for_activation_queue,
    require_pre_electra,
)

BASE_REWARDS_PER_EPOCH = 4


def process_epoch(state, spec: ChainSpec, E):
    """Epoch transition, fork-dispatched (per_epoch_processing.rs:44-52):
    phase0 multi-pass below; Altair+ the fused vectorized pass."""
    from ..metrics import start_timer
    from ..types.chain_spec import ForkName
    from ..types.containers import build_types

    from ..utils.tracing import span

    require_pre_electra(state, E, "process_epoch")
    fork = build_types(E).fork_of_state(state)
    # `epoch_transition` is a root-span name in the trace taxonomy
    # (OBSERVABILITY.md): standalone transitions land in the collector as
    # their own trees; boundary transitions inside a block import nest
    # under that trace's state_transition span
    with start_timer("epoch_transition_seconds"), span("epoch_transition"):
        if fork >= ForkName.ALTAIR:
            from .altair import process_epoch_altair

            process_epoch_altair(state, spec, E, fork)
        else:
            process_epoch_phase0(state, spec, E)


def process_epoch_phase0(state, spec: ChainSpec, E):
    """Phase0 epoch transition (runs at the last slot of each epoch),
    sharing the altair path's resident-columns machinery: one column
    view for every sweep, bulk diffed writebacks, per-stage spans."""
    from ..utils.tracing import span
    from .altair import EpochArrays
    from .registry_columns import registry_columns_for

    columns = registry_columns_for(state)
    if columns is not None:
        with span("epoch_stage_columns_refresh"):
            columns.refresh(state)
    arrays = EpochArrays(state, E, columns=columns)
    with span("epoch_stage_justification"):
        process_justification_and_finalization(state, E)
    with span("epoch_stage_rewards"):
        process_rewards_and_penalties(state, spec, E, arrays=arrays)
    with span("epoch_stage_registry_updates"):
        changed = process_registry_updates(state, spec, E, arrays=arrays)
        arrays.refresh_rows(state, changed)
    with span("epoch_stage_slashings"):
        process_slashings(state, E, arrays=arrays)
    process_eth1_data_reset(state, E)
    with span("epoch_stage_effective_balances"):
        process_effective_balance_updates(state, E, arrays=arrays)
    with span("epoch_stage_final_updates"):
        process_slashings_reset(state, E)
        process_randao_mixes_reset(state, E)
        process_historical_roots_update(state, E)
        process_participation_record_updates(state, E)
    invalidate_caches(state)


# ---------------------------------------------------------------------------
# Matching attestations
# ---------------------------------------------------------------------------


def get_matching_source_attestations(state, epoch: int, E):
    current = get_current_epoch(state, E)
    if epoch == current:
        return list(state.current_epoch_attestations)
    if epoch == get_previous_epoch(state, E):
        return list(state.previous_epoch_attestations)
    raise ValueError(f"no attestations stored for epoch {epoch}")


def get_matching_target_attestations(state, epoch: int, E):
    source = get_matching_source_attestations(state, epoch, E)
    if not source:
        # At an epoch's first slot the boundary root is not yet recorded in
        # block_roots; with no attestations there is nothing to match.
        return []
    root = get_block_root(state, epoch, E)
    return [a for a in source if a.data.target.root == root]


def get_matching_head_attestations(state, epoch: int, E):
    return [
        a
        for a in get_matching_target_attestations(state, epoch, E)
        if a.data.beacon_block_root == get_block_root_at_slot(state, a.data.slot, E)
    ]


def get_unslashed_attesting_indices(
    state, attestations, E, indices_cache: dict | None = None
) -> set[int]:
    out: set[int] = set()
    for a in attestations:
        if indices_cache is not None:
            indices = indices_cache.get(id(a))
            if indices is None:
                indices = get_attesting_indices(state, a.data, a.aggregation_bits, E)
                indices_cache[id(a)] = indices
        else:
            indices = get_attesting_indices(state, a.data, a.aggregation_bits, E)
        out.update(indices)
    return {i for i in out if not state.validators[i].slashed}


def get_attesting_balance(state, attestations, E) -> int:
    return get_total_balance(
        state, get_unslashed_attesting_indices(state, attestations, E), E
    )


# ---------------------------------------------------------------------------
# Justification & finalization
# ---------------------------------------------------------------------------


def process_justification_and_finalization(state, E):
    """Fork-dispatched: phase0 counts pending attestations; Altair+ counts
    participation flags (callers include fork choice's pull-up computation)."""
    if not hasattr(state, "previous_epoch_attestations"):
        from .altair import process_justification_and_finalization_altair

        process_justification_and_finalization_altair(state, E)
        return
    if get_current_epoch(state, E) <= GENESIS_EPOCH + 1:
        return
    previous_indices = get_unslashed_attesting_indices(
        state,
        get_matching_target_attestations(state, get_previous_epoch(state, E), E),
        E,
    )
    current_indices = get_unslashed_attesting_indices(
        state,
        get_matching_target_attestations(state, get_current_epoch(state, E), E),
        E,
    )
    total = get_total_active_balance(state, E)
    prev_balance = get_total_balance(state, previous_indices, E)
    cur_balance = get_total_balance(state, current_indices, E)
    weigh_justification_and_finalization(state, total, prev_balance, cur_balance, E)


def weigh_justification_and_finalization(
    state, total_active_balance, previous_epoch_target_balance,
    current_epoch_target_balance, E,
):
    from ..types.containers import build_types

    t = build_types(E)
    previous_epoch = get_previous_epoch(state, E)
    current_epoch = get_current_epoch(state, E)
    old_previous_justified = state.previous_justified_checkpoint
    old_current_justified = state.current_justified_checkpoint

    state.previous_justified_checkpoint = state.current_justified_checkpoint
    bits = list(state.justification_bits)
    bits = [False] + bits[:-1]
    if previous_epoch_target_balance * 3 >= total_active_balance * 2:
        state.current_justified_checkpoint = t.Checkpoint(
            epoch=previous_epoch, root=get_block_root(state, previous_epoch, E)
        )
        bits[1] = True
    if current_epoch_target_balance * 3 >= total_active_balance * 2:
        state.current_justified_checkpoint = t.Checkpoint(
            epoch=current_epoch, root=get_block_root(state, current_epoch, E)
        )
        bits[0] = True
    state.justification_bits = bits

    # Finalization (the four FFG rules)
    if (
        all(bits[1:4])
        and old_previous_justified.epoch + 3 == current_epoch
    ):
        state.finalized_checkpoint = old_previous_justified
    if (
        all(bits[1:3])
        and old_previous_justified.epoch + 2 == current_epoch
    ):
        state.finalized_checkpoint = old_previous_justified
    if all(bits[0:3]) and old_current_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_current_justified
    if all(bits[0:2]) and old_current_justified.epoch + 1 == current_epoch:
        state.finalized_checkpoint = old_current_justified


# ---------------------------------------------------------------------------
# Rewards & penalties
# ---------------------------------------------------------------------------


def get_base_reward(state, index: int, total_balance: int, E) -> int:
    eff = state.validators[index].effective_balance
    return safe_div(
        safe_div(safe_mul(eff, E.BASE_REWARD_FACTOR), int_sqrt(total_balance)),
        BASE_REWARDS_PER_EPOCH,
    )


def get_proposer_reward(state, index: int, total_balance: int, E) -> int:
    return get_base_reward(state, index, total_balance, E) // E.PROPOSER_REWARD_QUOTIENT


def get_finality_delay(state, E) -> int:
    return get_previous_epoch(state, E) - state.finalized_checkpoint.epoch


def is_in_inactivity_leak(state, E) -> bool:
    return get_finality_delay(state, E) > E.MIN_EPOCHS_TO_INACTIVITY_PENALTY


def get_eligible_validator_indices(state, E) -> list[int]:
    previous = get_previous_epoch(state, E)
    return [
        i
        for i, v in enumerate(state.validators)
        if is_active_validator(v, previous)
        or (v.slashed and previous + 1 < v.withdrawable_epoch)
    ]


def _attestation_component_deltas(
    state, attestations, total_balance, eligible, E, indices_cache
):
    n = len(state.validators)
    rewards = [0] * n
    penalties = [0] * n
    unslashed = get_unslashed_attesting_indices(state, attestations, E, indices_cache)
    attesting_balance = get_total_balance(state, unslashed, E)
    increment = E.EFFECTIVE_BALANCE_INCREMENT
    leak = is_in_inactivity_leak(state, E)
    for index in eligible:
        base = get_base_reward(state, index, total_balance, E)
        if index in unslashed:
            if leak:
                rewards[index] += base
            else:
                rewards[index] += (
                    base * (attesting_balance // increment)
                    // (total_balance // increment)
                )
        else:
            penalties[index] += base
    return rewards, penalties


def get_attestation_deltas_reference(state, E):
    """Per-validator Python loop deltas — the retained phase0 oracle the
    vectorized `get_attestation_deltas` is differentially tested against
    (tests/test_registry_columns.py)."""
    n = len(state.validators)
    total_balance = get_total_active_balance(state, E)
    eligible = get_eligible_validator_indices(state, E)
    previous = get_previous_epoch(state, E)

    source_atts = get_matching_source_attestations(state, previous, E)
    target_atts = get_matching_target_attestations(state, previous, E)
    head_atts = get_matching_head_attestations(state, previous, E)

    # One indices computation per attestation, shared by every pass below
    # (the reference folds this into ValidatorStatuses, single pass).
    indices_cache = {
        id(a): get_attesting_indices(state, a.data, a.aggregation_bits, E)
        for a in source_atts
    }

    rewards = [0] * n
    penalties = [0] * n
    for atts in (source_atts, target_atts, head_atts):
        r, p = _attestation_component_deltas(
            state, atts, total_balance, eligible, E, indices_cache
        )
        for i in range(n):
            rewards[i] += r[i]
            penalties[i] += p[i]

    # Inclusion delay (proposer + timely-inclusion micro rewards)
    for index in get_unslashed_attesting_indices(
        state, source_atts, E, indices_cache
    ):
        candidates = [a for a in source_atts if index in indices_cache[id(a)]]
        attestation = min(candidates, key=lambda a: a.inclusion_delay)
        proposer_reward = get_proposer_reward(state, index, total_balance, E)
        rewards[attestation.proposer_index] += proposer_reward
        max_attester_reward = (
            get_base_reward(state, index, total_balance, E) - proposer_reward
        )
        rewards[index] += max_attester_reward // attestation.inclusion_delay

    # Inactivity leak penalties
    if is_in_inactivity_leak(state, E):
        target_attesters = get_unslashed_attesting_indices(
            state, target_atts, E, indices_cache
        )
        finality_delay = get_finality_delay(state, E)
        for index in eligible:
            base = get_base_reward(state, index, total_balance, E)
            penalties[index] += (
                BASE_REWARDS_PER_EPOCH * base
                - get_proposer_reward(state, index, total_balance, E)
            )
            if index not in target_attesters:
                penalties[index] += (
                    # lint: allow(safe-arith) -- retained phase0 oracle, exact Python-int math kept verbatim
                    state.validators[index].effective_balance
                    * finality_delay
                    // E.INACTIVITY_PENALTY_QUOTIENT
                )
    return rewards, penalties


# u64-exactness of the vectorized phase0 math: eff ≤ 2**35 (32 ETH) and
# total_balance ≥ one increment (2**30, isqrt ≥ 2**15), so base =
# eff·64/isqrt/4 < 2**25; attesting/total increment ratios are < 2**26
# even at 10M validators ⇒ every product below stays under 2**51. The
# one escape is the leak's eff·finality_delay term, which gets a bigint
# fallback when a pathological delay could overflow.


def get_attestation_deltas(state, E, arrays=None):
    """Returns (rewards, penalties) uint64 arrays — phase0
    get_attestation_deltas as whole-registry masked array ops (mirroring
    the altair flag-delta path). Attestation-driven parts (per-attester
    inclusion-delay micro rewards) stay index loops — they are bounded by
    committee sizes, not the registry."""
    import numpy as np

    from .altair import EpochArrays

    n = len(state.validators)
    if arrays is None:
        arrays = EpochArrays(state, E)
    previous = get_previous_epoch(state, E)
    current = get_current_epoch(state, E)
    total_balance = arrays.total_active_balance(current, E)

    eff = arrays.effective_balance
    prev_active = arrays.active_at(previous)
    eligible = prev_active | (
        arrays.slashed & (np.uint64(previous + 1) < arrays.withdrawable_epoch)
    )
    base = div_u64(
        div_u64(
            mul_u64(eff, np.uint64(E.BASE_REWARD_FACTOR)),
            np.uint64(int_sqrt(total_balance)),
        ),
        np.uint64(BASE_REWARDS_PER_EPOCH),
    )
    proposer_r = base // np.uint64(E.PROPOSER_REWARD_QUOTIENT)

    source_atts = get_matching_source_attestations(state, previous, E)
    target_atts = get_matching_target_attestations(state, previous, E)
    head_atts = get_matching_head_attestations(state, previous, E)
    indices_cache = {
        id(a): get_attesting_indices(state, a.data, a.aggregation_bits, E)
        for a in source_atts
    }

    rewards = np.zeros(n, dtype=np.uint64)
    penalties = np.zeros(n, dtype=np.uint64)
    increment = E.EFFECTIVE_BALANCE_INCREMENT
    leak = is_in_inactivity_leak(state, E)
    total_increments = np.uint64(total_balance // increment)

    for atts in (source_atts, target_atts, head_atts):
        unslashed = get_unslashed_attesting_indices(
            state, atts, E, indices_cache
        )
        umask = np.zeros(n, dtype=bool)
        if unslashed:
            umask[np.fromiter(unslashed, dtype=np.int64)] = True
        attesting_balance = max(
            int(eff[umask].sum(dtype=np.uint64)), increment
        )
        got = eligible & umask
        if leak:
            rewards[got] += base[got]
        else:
            rewards[got] += (
                base[got] * np.uint64(attesting_balance // increment)
                // total_increments
            )
        missed = eligible & ~umask
        penalties[missed] += base[missed]

    # Inclusion delay (proposer + timely-inclusion micro rewards):
    # attestation-driven, so per-attester index updates into the arrays
    for index in get_unslashed_attesting_indices(
        state, source_atts, E, indices_cache
    ):
        candidates = [a for a in source_atts if index in indices_cache[id(a)]]
        attestation = min(candidates, key=lambda a: a.inclusion_delay)
        proposer_reward = int(proposer_r[index])
        rewards[attestation.proposer_index] += np.uint64(proposer_reward)
        max_attester_reward = int(base[index]) - proposer_reward
        rewards[index] += np.uint64(
            max_attester_reward // attestation.inclusion_delay
        )

    # Inactivity leak penalties
    if leak:
        target_attesters = get_unslashed_attesting_indices(
            state, target_atts, E, indices_cache
        )
        tmask = np.zeros(n, dtype=bool)
        if target_attesters:
            tmask[np.fromiter(target_attesters, dtype=np.int64)] = True
        finality_delay = get_finality_delay(state, E)
        penalties[eligible] += (
            np.uint64(BASE_REWARDS_PER_EPOCH) * base[eligible]
            - proposer_r[eligible]
        )
        inactive = eligible & ~tmask
        eb_max = int(eff.max(initial=0))
        if eb_max and finality_delay > (1 << 64) // eb_max:
            # pathological non-finality: exact bigint math per lane
            for i in np.nonzero(inactive)[0]:
                penalties[i] += np.uint64(
                    int(eff[i]) * finality_delay // E.INACTIVITY_PENALTY_QUOTIENT
                )
        else:
            penalties[inactive] += div_u64(
                mul_u64(eff[inactive], np.uint64(finality_delay)),
                np.uint64(E.INACTIVITY_PENALTY_QUOTIENT),
            )
    return rewards, penalties


def process_rewards_and_penalties_reference(state, spec: ChainSpec, E):
    """The retained per-validator apply loop (oracle)."""
    if get_current_epoch(state, E) == GENESIS_EPOCH:
        return
    rewards, penalties = get_attestation_deltas_reference(state, E)
    for i in range(len(state.validators)):
        increase_balance(state, i, rewards[i])
        decrease_balance(state, i, penalties[i])


def process_rewards_and_penalties(state, spec: ChainSpec, E, arrays=None):
    """Phase0 rewards/penalties as fused saturating array ops over the
    resident columns (mirroring the altair balance math): one vectorized
    delta computation, one bulk diffed writeback."""
    import numpy as np

    from .altair import EpochArrays

    if get_current_epoch(state, E) == GENESIS_EPOCH:
        return
    if arrays is None:
        arrays = EpochArrays(state, E)
    rewards, penalties = get_attestation_deltas(state, E, arrays=arrays)
    balances = arrays.load_balances(state)
    balances = add_u64(balances, rewards)
    balances = sub_u64_saturating(balances, penalties)
    arrays.store_balances(state, balances)


# ---------------------------------------------------------------------------
# Registry, slashings, final updates
# ---------------------------------------------------------------------------


def process_registry_updates(state, spec: ChainSpec, E, arrays=None):
    """Vectorized registry sweep (single_pass.rs:20 shape): eligibility,
    ejections, and the activation queue come from flat-array masks; only
    the (typically few) touched validators are written back. Returns the
    list of mutated validator indices so callers can refresh array
    snapshots in place instead of rebuilding."""
    import numpy as np

    from ..types.chain_spec import ForkName
    from ..types.containers import build_types

    fork = build_types(E).fork_of_state(state)
    current = get_current_epoch(state, E)
    electra = fork >= ForkName.ELECTRA
    vs = state.validators
    n = len(vs)

    if arrays is not None:
        # a mutable copy: the queue logic updates it in place below, and
        # the resident column may be CoW-shared with state copies
        eligibility = np.array(
            arrays.activation_eligibility_epoch, dtype=np.uint64, copy=True
        )
        effective = arrays.effective_balance
        activation = arrays.activation_epoch
        exit_ep = arrays.exit_epoch
    else:
        eligibility = np.fromiter(
            (v.activation_eligibility_epoch for v in vs), dtype=np.uint64, count=n
        )
        effective = np.fromiter(
            (v.effective_balance for v in vs), dtype=np.uint64, count=n
        )
        activation = np.fromiter(
            (v.activation_epoch for v in vs), dtype=np.uint64, count=n
        )
        exit_ep = np.fromiter((v.exit_epoch for v in vs), dtype=np.uint64, count=n)

    far = np.uint64(FAR_FUTURE_EPOCH)
    cur = np.uint64(current)
    changed: set[int] = set()

    # eligibility for the activation queue
    if electra:
        new_eligible = (eligibility == far) & (
            effective >= np.uint64(spec.min_activation_balance)
        )
    else:
        new_eligible = (eligibility == far) & (
            effective == np.uint64(E.MAX_EFFECTIVE_BALANCE)
        )
    from ..metrics import inc_counter

    bulk = getattr(vs, "set_fields_bulk", None)
    eligible_idx = np.nonzero(new_eligible)[0]
    if eligible_idx.size:
        if bulk is not None:
            bulk(
                eligible_idx.tolist(),
                "activation_eligibility_epoch",
                [current + 1] * int(eligible_idx.size),
            )
            inc_counter(
                "registry_columns_row_writebacks_total",
                int(eligible_idx.size),
                field="validators",
            )
        else:
            for i in eligible_idx:
                mutable_validator(state, int(i)).activation_eligibility_epoch = (
                    current + 1
                )
        eligibility[eligible_idx] = current + 1
        changed.update(int(i) for i in eligible_idx)

    # ejections (active + effective balance at/below the floor)
    active_mask = (activation <= cur) & (cur < exit_ep)
    ejectable = active_mask & (effective <= np.uint64(spec.ejection_balance))
    for i in np.nonzero(ejectable)[0]:
        initiate_validator_exit(state, int(i), spec, E)
        changed.add(int(i))

    # activation queue: eligibility finalized + not yet scheduled
    finalized = np.uint64(state.finalized_checkpoint.epoch)
    queue_mask = (eligibility <= finalized) & (activation == far)
    queue_idx = np.nonzero(queue_mask)[0]
    order = np.lexsort((queue_idx, eligibility[queue_idx]))
    activation_queue = queue_idx[order]
    if electra:
        # EIP-7251: activations are unbounded by count — the balance churn
        # is enforced upstream by the pending-deposit queue.
        limit = len(activation_queue)
    else:
        # Deneb (EIP-7514) caps the activation churn; exit churn is uncapped.
        active_count = int(active_mask.sum())
        limit = spec.activation_churn_limit(active_count, fork)
    target = compute_activation_exit_epoch(current, E)
    admitted = activation_queue[:limit]
    if len(admitted):
        if bulk is not None:
            bulk(
                [int(i) for i in admitted],
                "activation_epoch",
                [target] * len(admitted),
            )
            inc_counter(
                "registry_columns_row_writebacks_total",
                len(admitted),
                field="validators",
            )
        else:
            for i in admitted:
                mutable_validator(state, int(i)).activation_epoch = target
        changed.update(int(i) for i in admitted)
    return sorted(changed)


def process_slashings_reference(state, E):
    """The retained per-validator slashing sweep (oracle)."""
    epoch = get_current_epoch(state, E)
    total_balance = get_total_active_balance(state, E)
    adjusted = min(
        sum(state.slashings) * E.PROPORTIONAL_SLASHING_MULTIPLIER, total_balance
    )
    increment = E.EFFECTIVE_BALANCE_INCREMENT
    for index, v in enumerate(state.validators):
        if v.slashed and epoch + E.EPOCHS_PER_SLASHINGS_VECTOR // 2 == v.withdrawable_epoch:
            penalty = (
                # lint: allow(safe-arith) -- retained phase0 oracle, exact Python-int math kept verbatim
                v.effective_balance // increment * adjusted // total_balance * increment
            )
            decrease_balance(state, index, penalty)


def process_slashings(state, E, arrays=None):
    """Phase0 correlated slashings: the matched set comes from one column
    mask; the (few) penalties are computed exactly in Python ints and
    applied as a single saturating-sub bulk writeback (mirroring the
    altair path)."""
    import numpy as np

    from .altair import EpochArrays

    if arrays is None:
        arrays = EpochArrays(state, E)
    epoch = get_current_epoch(state, E)
    total_balance = arrays.total_active_balance(epoch, E)
    adjusted = min(
        sum(state.slashings) * E.PROPORTIONAL_SLASHING_MULTIPLIER, total_balance
    )
    target_epoch = np.uint64(epoch + E.EPOCHS_PER_SLASHINGS_VECTOR // 2)
    mask = arrays.slashed & (arrays.withdrawable_epoch == target_epoch)
    if not mask.any():
        return
    increment = E.EFFECTIVE_BALANCE_INCREMENT
    penalties = np.zeros(arrays.n, dtype=np.uint64)
    for index in np.nonzero(mask)[0]:
        eb = int(arrays.effective_balance[index])
        penalties[index] = eb // increment * adjusted // total_balance * increment
    balances = arrays.load_balances(state)
    arrays.store_balances(
        state, sub_u64_saturating(balances, penalties)
    )


def process_eth1_data_reset(state, E):
    next_epoch = get_current_epoch(state, E) + 1
    if next_epoch % E.EPOCHS_PER_ETH1_VOTING_PERIOD == 0:
        state.eth1_data_votes = []


def process_effective_balance_updates(state, E, arrays=None):
    """Hysteresis sweep as one vectorized pass; only out-of-band validators
    (a handful per epoch in steady state) get object writebacks — drained
    as one dirty-index batch by the next columns refresh."""
    import numpy as np

    n = len(state.validators)
    if arrays is not None:
        balances = arrays.load_balances(state)
        effective = arrays.effective_balance
    else:
        balances = np.asarray(state.balances, dtype=np.uint64)
        effective = np.fromiter(
            (v.effective_balance for v in state.validators),
            dtype=np.uint64,
            count=n,
        )
    hysteresis_increment = E.EFFECTIVE_BALANCE_INCREMENT // E.HYSTERESIS_QUOTIENT
    downward = np.uint64(hysteresis_increment * E.HYSTERESIS_DOWNWARD_MULTIPLIER)
    upward = np.uint64(hysteresis_increment * E.HYSTERESIS_UPWARD_MULTIPLIER)
    stale = (add_u64(balances, downward) < effective) | (
        add_u64(effective, upward) < balances
    )
    if not stale.any():
        return
    increment = np.uint64(E.EFFECTIVE_BALANCE_INCREMENT)
    new_eff = np.minimum(
        sub_u64(balances, balances % increment),
        np.uint64(E.MAX_EFFECTIVE_BALANCE),
    )
    stale_idx = np.nonzero(stale)[0]
    vs = state.validators
    if hasattr(vs, "set_fields_bulk"):
        from ..metrics import inc_counter

        # ONE bulk column store (shallow clones + a single dirty batch)
        # instead of a mutate() deep-copy per stale validator — the next
        # columns refresh drains the whole batch at once
        vs.set_fields_bulk(
            stale_idx.tolist(), "effective_balance", new_eff[stale_idx].tolist()
        )
        inc_counter(
            "registry_columns_row_writebacks_total",
            int(stale_idx.size),
            field="validators",
        )
    else:
        for i in stale_idx:
            mutable_validator(state, int(i)).effective_balance = int(new_eff[i])
    if arrays is not None and arrays.columns is None:
        # legacy snapshot: update in place through the sanctioned writer
        # (resident columns re-sync from the dirty drain instead — the
        # column may be CoW-shared)
        arrays.write_snapshot_rows(
            "effective_balance", stale_idx, new_eff[stale_idx]
        )


def process_slashings_reset(state, E):
    next_epoch = get_current_epoch(state, E) + 1
    state.slashings[next_epoch % E.EPOCHS_PER_SLASHINGS_VECTOR] = 0


def process_randao_mixes_reset(state, E):
    current = get_current_epoch(state, E)
    next_epoch = current + 1
    state.randao_mixes[next_epoch % E.EPOCHS_PER_HISTORICAL_VECTOR] = get_randao_mix(
        state, current, E
    )


def process_historical_roots_update(state, E):
    next_epoch = get_current_epoch(state, E) + 1
    if next_epoch % (E.SLOTS_PER_HISTORICAL_ROOT // E.SLOTS_PER_EPOCH) == 0:
        from ..types.containers import build_types

        t = build_types(E)
        batch = t.HistoricalBatch(
            block_roots=state.block_roots, state_roots=state.state_roots
        )
        state.historical_roots.append(batch.hash_tree_root())


def process_participation_record_updates(state, E):
    state.previous_epoch_attestations = state.current_epoch_attestations
    state.current_epoch_attestations = []
