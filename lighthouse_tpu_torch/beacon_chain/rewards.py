"""Block-reward attribution (the standard rewards API).

Mirrors beacon_node/http_api's block-rewards computation: replay the
block's operations on the parent state in spec order, measuring the
proposer's balance delta per component — proposer slashings, attester
slashings, attestations (the Altair proposer-reward share), and the sync
aggregate — so `/eth/v1/beacon/rewards/blocks/{block_id}` reports the
same numbers the transition actually credited."""

from __future__ import annotations

from ..state_processing import per_slot_processing
from ..state_processing.per_block import (
    ConsensusContext,
    process_attester_slashing,
    process_block_header,
    process_deposit,
    process_eth1_data,
    process_proposer_slashing,
    process_randao,
    process_voluntary_exit,
)
from ..types.chain_spec import ForkName


def compute_block_rewards(signed_block, pre_state, spec, E, types) -> dict:
    """Per-component proposer rewards for `signed_block` applied on its
    parent state. Returns the standard BlockRewards shape (gwei)."""
    block = signed_block.message
    state = pre_state.copy()
    while state.slot < block.slot:
        per_slot_processing(state, spec, E)
    fork = types.fork_of_state(state)
    if fork < ForkName.ALTAIR:
        # phase0 credits attestation inclusion rewards at EPOCH processing,
        # not in-block — a balance-delta replay would report a false zero.
        raise ValueError(
            "block rewards are computed for Altair+ blocks (phase0 proposer "
            "rewards accrue at epoch processing)"
        )
    ctxt = ConsensusContext(int(block.slot))
    process_block_header(state, block, ctxt, E)
    process_randao(state, block, spec, E, verify=False)
    process_eth1_data(state, block.body.eth1_data, E)
    proposer = int(block.proposer_index)
    body = block.body

    def bal() -> int:
        return int(state.balances[proposer])

    rewards = {"proposer_slashings": 0, "attester_slashings": 0,
               "attestations": 0, "sync_aggregate": 0}

    before = bal()
    for ps in body.proposer_slashings:
        process_proposer_slashing(state, ps, spec, E, False)
    rewards["proposer_slashings"] = bal() - before

    before = bal()
    for asl in body.attester_slashings:
        process_attester_slashing(state, asl, spec, E, False)
    rewards["attester_slashings"] = bal() - before

    before = bal()
    from ..state_processing.altair import process_attestation_altair

    for att in body.attestations:
        process_attestation_altair(state, att, spec, E, False, ctxt, fork)
    rewards["attestations"] = bal() - before

    # deposits/exits keep the replay faithful (they can touch the
    # proposer's own balance) but are not reward components
    for dep in body.deposits:
        process_deposit(state, dep, spec, E)
    for exit_ in body.voluntary_exits:
        process_voluntary_exit(state, exit_, spec, E, False)

    from ..state_processing.altair import process_sync_aggregate

    before = bal()
    process_sync_aggregate(state, body.sync_aggregate, spec, E, False, ctxt)
    rewards["sync_aggregate"] = bal() - before

    total = sum(rewards.values())
    return {
        "proposer_index": str(proposer),
        "total": str(total),
        "attestations": str(rewards["attestations"]),
        "sync_aggregate": str(rewards["sync_aggregate"]),
        "proposer_slashings": str(rewards["proposer_slashings"]),
        "attester_slashings": str(rewards["attester_slashings"]),
    }


def compute_attestation_rewards(state, spec, E, fork) -> dict:
    """Per-validator attestation rewards for the state's PREVIOUS epoch —
    the standard `/eth/v1/beacon/rewards/attestations/{epoch}` payload.
    `state` must sit inside epoch(previous)+1 (its previous-epoch
    participation is the requested epoch's), before the deltas apply.

    Mirrors the altair flag-delta formulas (the same math the vectorized
    epoch sweep applies), decomposed per flag + inactivity, plus the
    ideal rewards per effective-balance tier."""
    import numpy as np

    from ..state_processing.altair import (
        PARTICIPATION_FLAG_WEIGHTS,
        TIMELY_HEAD_FLAG_INDEX,
        TIMELY_SOURCE_FLAG_INDEX,
        TIMELY_TARGET_FLAG_INDEX,
        WEIGHT_DENOMINATOR,
        attestation_flag_deltas,
    )

    # THE sweep's own computation — the endpoint cannot drift from the
    # transition (state_processing/altair.py attestation_flag_deltas)
    flag_rewards, flag_penalties, inactivity, eligible, info = (
        attestation_flag_deltas(state, spec, E, fork)
    )
    flag_names = {
        TIMELY_SOURCE_FLAG_INDEX: "source",
        TIMELY_TARGET_FLAG_INDEX: "target",
        TIMELY_HEAD_FLAG_INDEX: "head",
    }
    signed = {
        flag_names[i]: flag_rewards[i].astype(np.int64)
        - flag_penalties[i].astype(np.int64)
        for i in range(len(PARTICIPATION_FLAG_WEIGHTS))
    }

    total_rewards = [
        {
            "validator_index": str(i),
            "head": str(int(signed["head"][i])),
            "target": str(int(signed["target"][i])),
            "source": str(int(signed["source"][i])),
            "inactivity": str(-int(inactivity[i])),
        }
        for i in np.nonzero(eligible)[0]
    ]

    # ideal rewards per effective-balance tier present in the registry
    ideal = []
    tai = info["total_active_increments"]
    for inc in sorted(set(int(x) for x in info["eb_increments"][eligible])):
        row = {"effective_balance": str(inc * E.EFFECTIVE_BALANCE_INCREMENT)}
        base = inc * info["base_reward_per_increment"]
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            row[flag_names[flag_index]] = str(
                0
                if info["in_leak"]  # no flag rewards during a leak
                else base * weight * info["upb_increments"][flag_index]
                // (tai * WEIGHT_DENOMINATOR)
            )
        row["inactivity"] = "0"
        ideal.append(row)
    return {"ideal_rewards": ideal, "total_rewards": total_rewards}


def compute_sync_committee_rewards(signed_block, pre_state, spec, E, types):
    """Per-validator sync-committee rewards for `signed_block` — the
    standard `/eth/v1/beacon/rewards/sync_committee/{block_id}` payload:
    participants earn `participant_reward`, absent committee members
    LOSE it (spec process_sync_aggregate). Returns a list of
    {"validator_index": str, "reward": str} (reward may be negative),
    one entry per committee position's validator (summed across
    duplicate positions)."""
    from ..state_processing.altair import sync_participant_reward
    from ..state_processing.per_block import _validator_index_by_pubkey

    block = signed_block.message
    body = block.body
    aggregate = getattr(body, "sync_aggregate", None)
    if aggregate is None:
        raise ValueError("pre-Altair block has no sync aggregate")
    state = pre_state.copy()
    while state.slot < block.slot:
        per_slot_processing(state, spec, E)

    # the transition's own formula (process_sync_aggregate)
    participant_reward = sync_participant_reward(state, E)

    deltas: dict[int, int] = {}
    for pk, bit in zip(
        state.current_sync_committee.pubkeys, aggregate.sync_committee_bits
    ):
        index = _validator_index_by_pubkey(state, bytes(pk))
        if index is None:
            raise ValueError("sync committee pubkey not in registry")
        deltas[index] = deltas.get(index, 0) + (
            participant_reward if bit else -participant_reward
        )
    return [
        {"validator_index": str(i), "reward": str(d)}
        for i, d in sorted(deltas.items())
    ]
