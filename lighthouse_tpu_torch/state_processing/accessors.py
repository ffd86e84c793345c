"""Beacon-state accessors, predicates and mutators (spec helpers).

Counterpart of lighthouse_tpu/state_processing/accessors.py, copied.

The committee machinery mirrors the reference's per-epoch `CommitteeCache`
(consensus/types/src/beacon_state/committee_cache.rs): one whole-list shuffle
per epoch, committees are slices of it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..types.chain_spec import FAR_FUTURE_EPOCH, ChainSpec, Domain
from ..utils.hash import sha256 as hash_bytes
from ..utils.safe_arith import safe_add, safe_div, safe_mul, saturating_sub
from .shuffle import compute_shuffled_index

MAX_RANDOM_BYTE = 255


def int_sqrt(n: int) -> int:
    """Largest x with x² ≤ n (spec integer_squareroot; overflow-safe —
    Python ints are arbitrary precision, the safe_arith analog is free)."""
    return math.isqrt(n)


# ---------------------------------------------------------------------------
# Epoch / slot math
# ---------------------------------------------------------------------------


def compute_epoch_at_slot(slot: int, E) -> int:
    return slot // E.SLOTS_PER_EPOCH


def compute_start_slot_at_epoch(epoch: int, E) -> int:
    return epoch * E.SLOTS_PER_EPOCH


def compute_activation_exit_epoch(epoch: int, E) -> int:
    return epoch + 1 + E.MAX_SEED_LOOKAHEAD


def get_current_epoch(state, E) -> int:
    return compute_epoch_at_slot(state.slot, E)


def get_previous_epoch(state, E) -> int:
    cur = get_current_epoch(state, E)
    return cur - 1 if cur > 0 else 0


# ---------------------------------------------------------------------------
# Validator predicates
# ---------------------------------------------------------------------------


def is_active_validator(v, epoch: int) -> bool:
    return v.activation_epoch <= epoch < v.exit_epoch


def is_eligible_for_activation_queue(v, E) -> bool:
    return (
        v.activation_eligibility_epoch == FAR_FUTURE_EPOCH
        and v.effective_balance == E.MAX_EFFECTIVE_BALANCE
    )


def is_eligible_for_activation(state, v) -> bool:
    return (
        v.activation_eligibility_epoch <= state.finalized_checkpoint.epoch
        and v.activation_epoch == FAR_FUTURE_EPOCH
    )


def is_slashable_validator(v, epoch: int) -> bool:
    return not v.slashed and v.activation_epoch <= epoch < v.withdrawable_epoch


def is_slashable_attestation_data(data_1, data_2) -> bool:
    """Double vote or surround vote (spec is_slashable_attestation_data)."""
    double = data_1 != data_2 and data_1.target.epoch == data_2.target.epoch
    surround = (
        data_1.source.epoch < data_2.source.epoch
        and data_2.target.epoch < data_1.target.epoch
    )
    return double or surround


def _fresh_columns(state):
    """The state's resident registry columns brought exactly up to date,
    or None for plain-list states. Refreshing drains the columns dirty
    channel, which re-freezes any outstanding `mutate()` handles — call
    sites must acquire write handles AFTER their accessor reads (the
    pattern every state-transition mutator follows)."""
    from .registry_columns import registry_columns_for

    cols = registry_columns_for(state)
    if cols is not None:
        cols.refresh(state)
    return cols


def active_validator_indices_array(state, epoch: int):
    """Active indices as an int64 array — one vectorized mask over the
    resident columns instead of a per-validator Python sweep (falls back
    to the object loop for plain-list states)."""
    import numpy as np

    cols = _fresh_columns(state)
    if cols is not None:
        return np.nonzero(cols.active_mask(epoch))[0]
    return np.fromiter(
        (
            i
            for i, v in enumerate(state.validators)
            if is_active_validator(v, epoch)
        ),
        dtype=np.int64,
    )


def get_active_validator_indices(state, epoch: int) -> list[int]:
    return active_validator_indices_array(state, epoch).tolist()


# ---------------------------------------------------------------------------
# Randomness & seeds
# ---------------------------------------------------------------------------


def get_randao_mix(state, epoch: int, E) -> bytes:
    return state.randao_mixes[epoch % E.EPOCHS_PER_HISTORICAL_VECTOR]


def get_seed(state, epoch: int, domain_type: int, E) -> bytes:
    mix = get_randao_mix(
        state, epoch + E.EPOCHS_PER_HISTORICAL_VECTOR - E.MIN_SEED_LOOKAHEAD - 1, E
    )
    return hash_bytes(
        domain_type.to_bytes(4, "little") + epoch.to_bytes(8, "little") + mix
    )


# ---------------------------------------------------------------------------
# Committees
# ---------------------------------------------------------------------------


def get_committee_count_per_slot(active_count: int, E) -> int:
    return max(
        1,
        min(
            E.MAX_COMMITTEES_PER_SLOT,
            active_count // E.SLOTS_PER_EPOCH // E.TARGET_COMMITTEE_SIZE,
        ),
    )


@dataclass
class CommitteeCache:
    """One epoch's shuffling: every committee is a slice of `shuffled`
    (committee_cache.rs analog). The whole epoch's assignment is ONE
    shuffled-permutation gather — active indices (a vectorized column
    mask) indexed by the batched swap-or-not permutation — held as an
    int64 array that committees slice zero-copy."""

    epoch: int
    seed: bytes
    shuffled: "object"  # np.ndarray[int64]
    committees_per_slot: int
    slots_per_epoch: int

    @classmethod
    def build(cls, state, epoch: int, E) -> "CommitteeCache":
        from .shuffle import _shuffled_positions

        active = active_validator_indices_array(state, epoch)
        seed = get_seed(state, epoch, Domain.BEACON_ATTESTER, E)
        if active.size > 1:
            perm = _shuffled_positions(active.size, seed, E.SHUFFLE_ROUND_COUNT)
            shuffled = active[perm]
        else:
            shuffled = active
        # freeze the permutation in ALL modes: every committee is a
        # zero-copy slice of it, and an in-place write through one slice
        # would silently corrupt every later consumer's assignment
        shuffled.setflags(write=False)
        return cls(
            epoch=epoch,
            seed=seed,
            shuffled=shuffled,
            committees_per_slot=get_committee_count_per_slot(active.size, E),
            slots_per_epoch=E.SLOTS_PER_EPOCH,
        )

    @property
    def committee_count(self) -> int:
        return self.committees_per_slot * self.slots_per_epoch

    def committee_array(self, slot: int, index: int):
        """The committee as a zero-copy int64 slice of the epoch's
        shuffled permutation — the batched attestation pipeline's gather
        source (no Python-list materialization)."""
        if index >= self.committees_per_slot:
            raise IndexError(
                f"committee index {index} >= {self.committees_per_slot}"
            )
        global_index = (
            slot % self.slots_per_epoch
        ) * self.committees_per_slot + index
        n = len(self.shuffled)
        count = self.committee_count
        start = n * global_index // count
        end = n * (global_index + 1) // count
        return self.shuffled[start:end]

    def committee(self, slot: int, index: int) -> list[int]:
        # plain ints out: members land in SSZ containers, dict keys and
        # signature sets — np.int64 leaking there is a foot-gun
        return self.committee_array(slot, index).tolist()

    def active_validator_count(self) -> int:
        return len(self.shuffled)


class EpochDutyTable:
    """A whole epoch's attester assignment inverted into arrays.

    `CommitteeCache.shuffled` maps committee offsets → validator indices;
    duties want the inverse (validator index → where it sits). One
    scatter builds the inverse permutation, and because committees are
    contiguous slices of `shuffled` with boundaries `n·g // count`, a
    searchsorted over the boundary array recovers (slot, committee index,
    position, committee size) for ANY set of validator indices in one
    vectorized pass — the duties_service's per-position Python sweep
    (8 slots × committees × members) becomes four array ops.
    """

    __slots__ = ("start_slot", "committees_per_slot", "_offset_of", "_starts")

    def __init__(self, cc: CommitteeCache, start_slot: int, n_validators: int):
        import numpy as np

        n = len(cc.shuffled)
        offset_of = np.full(n_validators, -1, dtype=np.int64)
        offset_of[cc.shuffled] = np.arange(n, dtype=np.int64)
        g = np.arange(cc.committee_count + 1, dtype=np.int64)
        self._starts = n * g // cc.committee_count
        self._offset_of = offset_of
        self.start_slot = int(start_slot)
        self.committees_per_slot = cc.committees_per_slot

    def lookup(self, indices):
        """(found_mask, slot, committee_index, position, committee_size)
        int64 arrays over `indices` — rows where found_mask is False
        (inactive or out-of-range validator) carry no duty this epoch;
        the duty arrays are aligned to indices[found_mask]."""
        import numpy as np

        idx = np.asarray(indices, dtype=np.int64)
        found = (idx >= 0) & (idx < self._offset_of.shape[0])
        off = self._offset_of[np.where(found, idx, 0)]
        found &= off >= 0
        off = off[found]
        g = np.searchsorted(self._starts, off, side="right") - 1
        slot = self.start_slot + g // self.committees_per_slot
        committee_index = g % self.committees_per_slot
        position = off - self._starts[g]
        size = self._starts[g + 1] - self._starts[g]
        return found, slot, committee_index, position, size


def epoch_duty_table(state, epoch: int, E) -> EpochDutyTable:
    """The epoch's `EpochDutyTable`, cached on the state alongside its
    committee caches (same epoch-range discipline)."""
    caches = _caches(state)
    dt = caches.duty_tables.get(epoch)
    if dt is None:
        cc = committee_cache_at(state, epoch, E)
        dt = EpochDutyTable(
            cc, compute_start_slot_at_epoch(epoch, E), len(state.validators)
        )
        caches.duty_tables[epoch] = dt
    return dt


class StateCaches:
    """Per-state transient caches (committee shufflings by epoch). Attached
    lazily to a BeaconState instance — the reference keeps these inside the
    state object (beacon_state/committee_cache)."""

    __slots__ = ("committees", "duty_tables")

    def __init__(self):
        self.committees: dict[int, CommitteeCache] = {}
        self.duty_tables: dict[int, EpochDutyTable] = {}


def _caches(state) -> StateCaches:
    c = getattr(state, "_lh_caches", None)
    if c is None:
        c = StateCaches()
        object.__setattr__(state, "_lh_caches", c)
    return c


def invalidate_caches(state):
    if hasattr(state, "_lh_caches"):
        object.__setattr__(state, "_lh_caches", StateCaches())


def committee_cache_at(state, epoch: int, E) -> CommitteeCache:
    cur = get_current_epoch(state, E)
    if not (cur - 1 <= epoch <= cur + 1):
        raise ValueError(
            f"committee cache only for epochs {cur-1}..{cur+1}, got {epoch}"
        )
    caches = _caches(state)
    cc = caches.committees.get(epoch)
    if cc is None or cc.epoch != epoch:
        cc = CommitteeCache.build(state, epoch, E)
        caches.committees[epoch] = cc
    return cc


def get_beacon_committee(state, slot: int, index: int, E) -> list[int]:
    epoch = compute_epoch_at_slot(slot, E)
    return committee_cache_at(state, epoch, E).committee(slot, index)


# ---------------------------------------------------------------------------
# Proposer selection
# ---------------------------------------------------------------------------


def compute_proposer_index(state, indices: list[int], seed: bytes, E) -> int:
    assert indices
    total = len(indices)
    i = 0
    while True:
        candidate = indices[compute_shuffled_index(i % total, total, seed, E.SHUFFLE_ROUND_COUNT)]
        random_byte = hash_bytes(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        eff = state.validators[candidate].effective_balance
        if safe_mul(eff, MAX_RANDOM_BYTE) >= E.MAX_EFFECTIVE_BALANCE * random_byte:
            return candidate
        i += 1


def get_beacon_proposer_index(state, E, slot: int | None = None) -> int:
    slot = state.slot if slot is None else slot
    epoch = compute_epoch_at_slot(slot, E)
    seed = hash_bytes(
        get_seed(state, epoch, Domain.BEACON_PROPOSER, E)
        + slot.to_bytes(8, "little")
    )
    indices = get_active_validator_indices(state, epoch)
    return compute_proposer_index(state, indices, seed, E)


# ---------------------------------------------------------------------------
# Balances
# ---------------------------------------------------------------------------


def get_total_balance(state, indices, E) -> int:
    total = sum(state.validators[i].effective_balance for i in indices)
    return max(E.EFFECTIVE_BALANCE_INCREMENT, total)


def get_total_active_balance(state, E) -> int:
    cols = _fresh_columns(state)
    if cols is not None:
        import numpy as np

        epoch = get_current_epoch(state, E)
        total = int(
            cols.effective_balance[cols.active_mask(epoch)].sum(
                dtype=np.uint64
            )
        )
        return max(E.EFFECTIVE_BALANCE_INCREMENT, total)
    return get_total_balance(
        state, get_active_validator_indices(state, get_current_epoch(state, E)), E
    )


def increase_balance(state, index: int, delta: int):
    # zero-delta rewards are common (empty committees); skipping the write
    # keeps the registry's dirty-index tracker (ssz/persistent.py) from
    # recording — and the hash cache from re-rooting — untouched paths
    if delta:
        state.balances[index] = safe_add(state.balances[index], delta)


def decrease_balance(state, index: int, delta: int):
    if delta:
        state.balances[index] = saturating_sub(state.balances[index], delta)


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
# Attestation helpers
# ---------------------------------------------------------------------------


def attesting_indices_array(state, data, aggregation_bits, E):
    """Attesting validator indices as a SORTED int64 array: one boolean
    gather over the committee's zero-copy permutation slice — the shared
    columnar source for indexed-attestation assembly, the batched block
    pipeline, signature sets and the slasher/fork-choice feed."""
    import numpy as np

    epoch = compute_epoch_at_slot(data.slot, E)
    cc = committee_cache_at(state, epoch, E)
    committee = cc.committee_array(data.slot, data.index)
    if len(aggregation_bits) != committee.size:
        raise ValueError(
            f"aggregation bits length {len(aggregation_bits)} != committee "
            f"size {committee.size}"
        )
    mask = np.asarray(aggregation_bits, dtype=bool)
    picked = committee[mask]
    picked = np.sort(picked)
    return picked


def get_attesting_indices(state, data, aggregation_bits, E) -> list[int]:
    # plain ints out (SSZ containers, dict keys, signature sets)
    return attesting_indices_array(state, data, aggregation_bits, E).tolist()


def get_indexed_attestation(state, attestation, E):
    from ..types.containers import build_types

    t = build_types(E)
    indices = get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits, E
    )
    return t.IndexedAttestation(
        attesting_indices=indices,
        data=attestation.data,
        signature=attestation.signature,
    )


def get_domain(state, domain_type: int, epoch: int | None, spec: ChainSpec, E) -> bytes:
    epoch = get_current_epoch(state, E) if epoch is None else epoch
    return spec.get_domain(
        epoch, domain_type, state.fork, state.genesis_validators_root
    )


# ---------------------------------------------------------------------------
# Validator mutators
# ---------------------------------------------------------------------------


def get_validator_churn_limit(state, spec: ChainSpec, E) -> int:
    active = len(get_active_validator_indices(state, get_current_epoch(state, E)))
    return spec.churn_limit(active)


def mutable_validator(state, index: int):
    """Write-safe validator access. A PersistentContainerList registry
    shares element objects across state copies, so field mutation must go
    through its copy-on-write `mutate()`; plain-list registries own their
    elements and return them directly. EVERY validator field write in the
    state transition uses this helper (the milhouse `&mut` discipline)."""
    vs = state.validators
    m = getattr(vs, "mutate", None)
    return m(index) if m is not None else vs[index]


def initiate_validator_exit(state, index: int, spec: ChainSpec, E):
    if hasattr(state, "earliest_exit_epoch"):
        # Electra: weight-denominated exit churn (EIP-7251)
        from .electra import initiate_validator_exit_electra

        initiate_validator_exit_electra(state, index, spec, E)
        return
    if state.validators[index].exit_epoch != FAR_FUTURE_EPOCH:
        return
    # All queue reads happen BEFORE the mutate() handle is taken: the
    # columns fast paths drain the dirty channel, which re-freezes any
    # outstanding handles (a stale-handle write would be invisible to
    # the drained delta).
    cols = _fresh_columns(state)
    floor = compute_activation_exit_epoch(get_current_epoch(state, E), E)
    if cols is not None:
        import numpy as np

        ee = cols.exit_epoch
        exiting = ee[ee != np.uint64(FAR_FUTURE_EPOCH)]
        exit_queue_epoch = max(
            int(exiting.max()) if exiting.size else 0, floor
        )
        exit_queue_churn = int(
            (ee == np.uint64(exit_queue_epoch)).sum()
        )
    else:
        exit_epochs = [
            w.exit_epoch
            for w in state.validators
            if w.exit_epoch != FAR_FUTURE_EPOCH
        ]
        exit_queue_epoch = max(exit_epochs + [floor])
        exit_queue_churn = sum(
            1 for w in state.validators if w.exit_epoch == exit_queue_epoch
        )
    if exit_queue_churn >= get_validator_churn_limit(state, spec, E):
        exit_queue_epoch += 1
    v = mutable_validator(state, index)
    v.exit_epoch = exit_queue_epoch
    v.withdrawable_epoch = (
        exit_queue_epoch + spec.min_validator_withdrawability_delay
    )


def slash_validator(
    state, slashed_index: int, spec: ChainSpec, E, whistleblower_index=None
):
    from ..types.chain_spec import ForkName
    from ..types.containers import build_types

    fork = build_types(E).fork_of_state(state)
    epoch = get_current_epoch(state, E)
    initiate_validator_exit(state, slashed_index, spec, E)
    v = mutable_validator(state, slashed_index)
    v.slashed = True
    v.withdrawable_epoch = max(
        v.withdrawable_epoch, epoch + E.EPOCHS_PER_SLASHINGS_VECTOR
    )
    state.slashings[epoch % E.EPOCHS_PER_SLASHINGS_VECTOR] = safe_add(
        state.slashings[epoch % E.EPOCHS_PER_SLASHINGS_VECTOR],
        v.effective_balance,
    )
    if fork >= ForkName.ELECTRA:
        quotient = spec.min_slashing_penalty_quotient_electra
    elif fork >= ForkName.BELLATRIX:
        quotient = E.MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX
    elif fork >= ForkName.ALTAIR:
        quotient = E.MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR
    else:
        quotient = E.MIN_SLASHING_PENALTY_QUOTIENT
    decrease_balance(state, slashed_index, safe_div(v.effective_balance, quotient))
    proposer_index = get_beacon_proposer_index(state, E)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    wb_quotient = (
        spec.whistleblower_reward_quotient_electra
        if fork >= ForkName.ELECTRA
        else E.WHISTLEBLOWER_REWARD_QUOTIENT
    )
    whistleblower_reward = safe_div(v.effective_balance, wb_quotient)
    if fork >= ForkName.ALTAIR:
        from .altair import PROPOSER_WEIGHT, WEIGHT_DENOMINATOR

        proposer_reward = whistleblower_reward * PROPOSER_WEIGHT // WEIGHT_DENOMINATOR
    else:
        proposer_reward = whistleblower_reward // E.PROPOSER_REWARD_QUOTIENT
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(
        state, whistleblower_index, whistleblower_reward - proposer_reward
    )
