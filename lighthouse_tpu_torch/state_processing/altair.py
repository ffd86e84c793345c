"""Altair+ state transition: participation flags, sync committees, and the
fused, vectorized epoch sweep.

Counterpart of lighthouse_tpu/state_processing/altair.py, copied, except
the sweep's seam (`_device_sweep_applicable`, `_device_rewards_and_inactivity`):
the epoch-sweep kernel runs wherever the host u64 guard admits the state,
on the default device (lighthouse_tpu_torch/device.py), with no flag and
no process-wide side effect; the numpy sweep runs where the guard does not
admit it (the genesis epoch, effective_balance·score near 2^64).

Reference parity: consensus/state_processing/src/per_epoch_processing/
altair.rs:55 dispatching into single_pass.rs:20 (the fused all-validator
epoch loop), per_block_processing/altair/sync_committee.rs (sync-aggregate
processing), and the altair/bellatrix/deneb consensus specs.

TPU-first design: the reference fuses its epoch loops into one sequential
pass per validator (single_pass.rs). Here the same sweeps are expressed as
whole-registry numpy u64/u8 array arithmetic — flags, balances, effective
balances and inactivity scores live in flat arrays, every per-validator
branch becomes a mask, and the arithmetic is exactly-u64 (checked: every
intermediate product stays below 2**64; see _REWARD_RANGE_DOC). This is the
memory layout the device epoch kernel consumes directly.
"""

from __future__ import annotations

import numpy as np

from ..types.chain_spec import ChainSpec, ForkName
from ..utils.safe_arith import (
    add_u64,
    div_u64,
    mul_u64,
    safe_div,
    safe_mul,
    sub_u64_saturating,
)
from .accessors import (
    compute_epoch_at_slot,
    decrease_balance,
    electra_not_ported,
    get_active_validator_indices,
    get_beacon_committee,
    get_block_root,
    get_block_root_at_slot,
    get_current_epoch,
    get_domain,
    get_previous_epoch,
    get_seed,
    get_total_active_balance,
    increase_balance,
    int_sqrt,
    invalidate_caches,
)
from .per_epoch import weigh_justification_and_finalization
from .shuffle import compute_shuffled_index

# --- Participation flags (altair/beacon-chain.md) ---------------------------

TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2

TIMELY_SOURCE_WEIGHT = 14
TIMELY_TARGET_WEIGHT = 26
TIMELY_HEAD_WEIGHT = 14
SYNC_REWARD_WEIGHT = 2
PROPOSER_WEIGHT = 8
WEIGHT_DENOMINATOR = 64

PARTICIPATION_FLAG_WEIGHTS = [
    TIMELY_SOURCE_WEIGHT,
    TIMELY_TARGET_WEIGHT,
    TIMELY_HEAD_WEIGHT,
]

# u64-exactness argument for the vectorized reward math:
#   effective_balance <= 2**35 (32 ETH in gwei), base_reward < 2**27 even on
#   tiny nets, weight <= 64 = 2**6, participating increments < 2**26 at 10M
#   validators => base_reward * weight * increments < 2**59. The inactivity
#   penalty computes eb * inactivity_score: safe while score < 2**28 (scores
#   grow 4/epoch during leaks; 2**28 would need ~2M years of leaking) —
#   asserted below rather than assumed.
_REWARD_RANGE_DOC = True


def has_flag(flags: int, flag_index: int) -> bool:
    return bool(flags & (1 << flag_index))


def add_flag(flags: int, flag_index: int) -> int:
    return flags | (1 << flag_index)


# --- Base rewards -----------------------------------------------------------


def get_base_reward_per_increment(state, E) -> int:
    return (
        E.EFFECTIVE_BALANCE_INCREMENT
        * E.BASE_REWARD_FACTOR
        // int_sqrt(get_total_active_balance(state, E))
    )


def get_base_reward_altair(state, index: int, E) -> int:
    increments = safe_div(
        state.validators[index].effective_balance, E.EFFECTIVE_BALANCE_INCREMENT
    )
    return increments * get_base_reward_per_increment(state, E)


# --- Attestation participation (altair process_attestation) ----------------


def get_attestation_participation_flag_indices(
    state, data, inclusion_delay: int, E, fork: ForkName
) -> list[int]:
    from .per_block import BlockProcessingError

    if data.target.epoch == get_current_epoch(state, E):
        justified_checkpoint = state.current_justified_checkpoint
    else:
        justified_checkpoint = state.previous_justified_checkpoint

    is_matching_source = data.source == justified_checkpoint
    if not is_matching_source:
        raise BlockProcessingError("attestation: source checkpoint mismatch")
    is_matching_target = is_matching_source and data.target.root == get_block_root(
        state, data.target.epoch, E
    )
    is_matching_head = (
        is_matching_target
        and data.beacon_block_root == get_block_root_at_slot(state, data.slot, E)
    )

    flags = []
    if is_matching_source and inclusion_delay <= int_sqrt(E.SLOTS_PER_EPOCH):
        flags.append(TIMELY_SOURCE_FLAG_INDEX)
    if fork >= ForkName.DENEB:
        # EIP-7045: no inclusion-delay bound on the target flag.
        if is_matching_target:
            flags.append(TIMELY_TARGET_FLAG_INDEX)
    elif is_matching_target and inclusion_delay <= E.SLOTS_PER_EPOCH:
        flags.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == E.MIN_ATTESTATION_INCLUSION_DELAY:
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


def process_attestation_altair(
    state, attestation, spec: ChainSpec, E, verify_signatures: bool, ctxt, fork
):
    from .accessors import committee_cache_at
    from .per_block import BlockProcessingError, is_valid_indexed_attestation

    data = attestation.data
    current = get_current_epoch(state, E)
    previous = get_previous_epoch(state, E)
    if data.target.epoch not in (previous, current):
        raise BlockProcessingError("attestation: target epoch out of range")
    if data.target.epoch != compute_epoch_at_slot(data.slot, E):
        raise BlockProcessingError("attestation: target/slot mismatch")
    if state.slot < data.slot + E.MIN_ATTESTATION_INCLUSION_DELAY:
        raise BlockProcessingError("attestation: too early")
    if fork < ForkName.DENEB and state.slot > data.slot + E.SLOTS_PER_EPOCH:
        # EIP-7045 (Deneb) removed the one-epoch inclusion upper bound.
        raise BlockProcessingError("attestation: inclusion window")
    cc = committee_cache_at(state, data.target.epoch, E)
    if data.index >= cc.committees_per_slot:
        raise BlockProcessingError("attestation: committee index out of range")
    committee = get_beacon_committee(state, data.slot, data.index, E)
    if len(attestation.aggregation_bits) != len(committee):
        raise BlockProcessingError("attestation: bitfield length mismatch")

    inclusion_delay = state.slot - data.slot
    flag_indices = get_attestation_participation_flag_indices(
        state, data, inclusion_delay, E, fork
    )

    indexed = ctxt.get_indexed_attestation(state, attestation, E)
    if not is_valid_indexed_attestation(
        state, indexed, spec, E, verify_signature=verify_signatures
    ):
        raise BlockProcessingError("attestation: invalid indexed attestation")

    participation = (
        state.current_epoch_participation
        if data.target.epoch == current
        else state.previous_epoch_participation
    )
    base_reward_per_increment = get_base_reward_per_increment(state, E)
    proposer_reward_numerator = 0
    for index in indexed.attesting_indices:
        eb_increments = safe_div(
            state.validators[index].effective_balance,
            E.EFFECTIVE_BALANCE_INCREMENT,
        )
        base_reward = eb_increments * base_reward_per_increment
        flags = participation[index]
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            if flag_index in flag_indices and not has_flag(flags, flag_index):
                flags = add_flag(flags, flag_index)
                proposer_reward_numerator += base_reward * weight
        participation[index] = flags

    proposer_reward_denominator = (
        (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
        * WEIGHT_DENOMINATOR
        // PROPOSER_WEIGHT
    )
    increase_balance(
        state,
        ctxt.get_proposer_index(state, E),
        proposer_reward_numerator // proposer_reward_denominator,
    )


# --- Sync committees --------------------------------------------------------


def get_next_sync_committee_indices_reference(state, E) -> list[int]:
    """altair/beacon-chain.md get_next_sync_committee_indices, verbatim:
    one shuffled-index computation and one hash per candidate. Retained
    as the differential oracle for the batched sampler below."""
    from ..types.chain_spec import Domain
    from ..utils.hash import sha256 as hash_bytes

    epoch = get_current_epoch(state, E) + 1
    active = get_active_validator_indices(state, epoch)
    active_count = len(active)
    seed = get_seed(state, epoch, Domain.SYNC_COMMITTEE, E)
    indices: list[int] = []
    i = 0
    while len(indices) < E.SYNC_COMMITTEE_SIZE:
        shuffled = compute_shuffled_index(
            i % active_count, active_count, seed, E.SHUFFLE_ROUND_COUNT
        )
        candidate = active[shuffled]
        random_byte = hash_bytes(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        effective_balance = state.validators[candidate].effective_balance
        if safe_mul(effective_balance, 255) >= E.MAX_EFFECTIVE_BALANCE * random_byte:
            indices.append(candidate)
        i += 1
    return indices


def get_next_sync_committee_indices(state, E) -> list[int]:
    """Batched effective-balance-weighted sampling: the whole shuffled
    permutation is computed once (one batched-hash pass per swap-or-not
    round, shuffle._shuffled_positions) instead of one
    `compute_shuffled_index` walk per candidate, and each 32-candidate
    window's randomness is ONE `hash_messages` call over the window seeds
    rather than 32 sequential hashlib calls. Selection order and output
    are bit-identical to the reference above (asserted by the
    differential suite)."""
    from ..types.chain_spec import Domain
    from ..utils.sha256_batch import hash_messages
    from .shuffle import _shuffled_positions

    epoch = get_current_epoch(state, E) + 1
    active = np.asarray(get_active_validator_indices(state, epoch), dtype=np.int64)
    active_count = int(active.size)
    seed = get_seed(state, epoch, Domain.SYNC_COMMITTEE, E)
    if active_count > 1:
        candidates = active[
            _shuffled_positions(active_count, seed, E.SHUFFLE_ROUND_COUNT)
        ]
    else:
        candidates = active
    from .registry_columns import registry_columns_for

    cols = registry_columns_for(state)
    if cols is not None:
        cols.refresh(state)
    # u64-exactness: eff·255 < 2^49 and max_eb·byte < 2^49 even at the
    # electra 2048-ETH ceiling, so the acceptance test vectorizes exactly
    max_eb = np.uint64(E.MAX_EFFECTIVE_BALANCE)
    indices: list[int] = []
    window = 0
    # hash a handful of 32-candidate windows per batch call (at ~50%
    # acceptance the committee needs ~SYNC_COMMITTEE_SIZE/16 windows),
    # and gather effective balances ONLY for the candidates actually
    # examined — the committee normally samples a tiny prefix of the
    # shuffled cycle, so a whole-active-set gather (or a per-validator
    # object pass on plain chains) would dwarf the sampling itself
    batch = max(1, E.SYNC_COMMITTEE_SIZE // 16)
    need = E.SYNC_COMMITTEE_SIZE
    while len(indices) < need:
        msgs = np.frombuffer(
            b"".join(
                seed + (window + w).to_bytes(8, "little") for w in range(batch)
            ),
            dtype=np.uint8,
        ).reshape(batch, 40)
        randomness = hash_messages(msgs).reshape(-1)  # batch*32 bytes
        pos = (
            np.arange(window * 32, (window + batch) * 32, dtype=np.int64)
            % active_count
        )
        cand = candidates[pos]
        if cols is not None:
            eff = cols.effective_balance[cand]
        else:
            vs = state.validators
            eff = np.fromiter(
                (vs[int(c)].effective_balance for c in cand.tolist()),
                dtype=np.uint64,
                count=int(cand.size),
            )
        ok = eff * np.uint64(255) >= max_eb * randomness.astype(np.uint64)
        picked = cand[ok]
        take = min(need - len(indices), int(picked.size))
        indices.extend(picked[:take].tolist())
        window += batch
    return indices


def get_next_sync_committee(state, E):
    from ..crypto import bls
    from ..types.containers import build_types

    t = build_types(E)
    indices = get_next_sync_committee_indices(state, E)
    pubkeys = [state.validators[i].pubkey for i in indices]
    aggregate = bls.aggregate_pubkeys(
        [bls.PublicKey(pk) for pk in pubkeys]
    ).to_bytes()
    return t.SyncCommittee(pubkeys=pubkeys, aggregate_pubkey=aggregate)


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


def sync_participant_reward(state, E) -> int:
    """Per-participant sync-committee reward for one slot (spec
    process_sync_aggregate). Shared by the transition and the rewards
    API so the endpoint reports exactly what the transition credits."""
    total_active_increments = (
        get_total_active_balance(state, E) // E.EFFECTIVE_BALANCE_INCREMENT
    )
    total_base_rewards = (
        get_base_reward_per_increment(state, E) * total_active_increments
    )
    max_participant_rewards = (
        total_base_rewards
        * SYNC_REWARD_WEIGHT
        // WEIGHT_DENOMINATOR
        // E.SLOTS_PER_EPOCH
    )
    return max_participant_rewards // E.SYNC_COMMITTEE_SIZE


def process_sync_aggregate(
    state, sync_aggregate, spec: ChainSpec, E, verify_signatures: bool, ctxt
):
    from ..crypto import bls
    from .per_block import BlockProcessingError

    if verify_signatures:
        participant_pubkeys = [
            pk
            for pk, bit in zip(
                state.current_sync_committee.pubkeys,
                sync_aggregate.sync_committee_bits,
            )
            if bit
        ]
        sig = bls.Signature(sync_aggregate.sync_committee_signature)
        if not participant_pubkeys:
            # eth_fast_aggregate_verify: empty participants require the
            # infinity signature (G2 point at infinity).
            if not sig.is_infinity():
                raise BlockProcessingError("sync aggregate: bad empty signature")
        elif not sync_aggregate_signature_set(
            state, sync_aggregate, state.slot, spec, E
        ).verify():
            raise BlockProcessingError("sync aggregate: invalid signature")

    # Rewards (sync_committee.rs / spec process_sync_aggregate)
    participant_reward = sync_participant_reward(state, E)
    proposer_reward = (
        participant_reward * PROPOSER_WEIGHT // (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
    )

    proposer_index = ctxt.get_proposer_index(state, E)
    committee_indices = [
        _validator_index_of(state, pk)
        for pk in state.current_sync_committee.pubkeys
    ]
    for participant_index, bit in zip(
        committee_indices, sync_aggregate.sync_committee_bits
    ):
        if bit:
            increase_balance(state, participant_index, participant_reward)
            increase_balance(state, proposer_index, proposer_reward)
        else:
            decrease_balance(state, participant_index, participant_reward)


def _validator_index_of(state, pubkey: bytes) -> int:
    from .per_block import _validator_index_by_pubkey

    index = _validator_index_by_pubkey(state, pubkey)
    if index is None:
        from .per_block import BlockProcessingError

        raise BlockProcessingError("sync committee pubkey not in registry")
    return index


# --- Vectorized epoch processing -------------------------------------------


def _participation_array(field, column, n: int) -> np.ndarray:
    """Participation flags as a [n] uint8 array: the resident column when
    attached (zero-copy view), `np.frombuffer` for the plain-bytearray
    representation, and a one-shot `load_array` extraction for a
    persistent list without columns (the LIGHTHOUSE_TPU_RESIDENT_COLUMNS=0
    oracle path). Always read-only: the sweep consumers are pure readers,
    and flag writes go through the attestation pipeline's writers."""
    from ..analysis.sanitizer import freeze_view

    if column is not None:
        return column  # RegistryColumns property: already frozen
    if isinstance(field, (bytes, bytearray)):
        return freeze_view(np.frombuffer(field, dtype=np.uint8, count=n))
    return freeze_view(field.load_array())


class EpochArrays:
    """Flat-array registry view for one epoch transition — the TPU-side
    layout (single_pass.rs's per-validator struct turned into columns).

    Two backings:

      * **resident** (`columns` given): every array is a live view of the
        state's RegistryColumns — nothing is rebuilt, the transition
        starts on whatever the last refresh left resident (the
        zero-rebuild path at 1M validators). Balance/score sweeps go
        through `load_*`/`store_*`, which diff against the resident
        column and write only changed rows back into the persistent
        lists (exact dirty indices to the hash caches).
      * **legacy snapshot** (no columns): the per-validator
        ``np.fromiter`` passes and ``tolist()`` writebacks of the r2-r5
        era — kept verbatim as the per-validator oracle the bench's
        vs_baseline control and the differential suite run against, and
        as the fallback for plain-list states.
    """

    def __init__(self, state, E, columns=None):
        n = len(state.validators)
        self.n = n
        self.columns = columns
        self._snap: dict[str, np.ndarray] = {}
        if columns is not None:
            if columns.validator_count != n:
                raise ValueError(
                    "EpochArrays over stale columns: refresh() first"
                )
        else:
            vs = state.validators
            for name in (
                "effective_balance",
                "activation_epoch",
                "exit_epoch",
                "withdrawable_epoch",
            ):
                self._snap[name] = np.fromiter(
                    (v.__dict__[name] for v in vs), dtype=np.uint64, count=n
                )
            self._snap["slashed"] = np.fromiter(
                (v.slashed for v in vs), dtype=bool, count=n
            )
            # write-guard the snapshot buffers in ALL modes: the only
            # sanctioned write windows are write_snapshot_rows and
            # refresh_rows (sanitizer.writable_window re-enables inside)
            for arr in self._snap.values():
                arr.setflags(write=False)
        if hasattr(state, "previous_epoch_participation"):
            self.prev_participation = _participation_array(
                state.previous_epoch_participation,
                None if columns is None else columns.previous_epoch_participation,
                n,
            )
            self.curr_participation = _participation_array(
                state.current_epoch_participation,
                None if columns is None else columns.current_epoch_participation,
                n,
            )
        else:  # phase0: no participation flags
            self.prev_participation = None
            self.curr_participation = None
        self._state = state

    def _col(self, name: str) -> np.ndarray:
        if self.columns is not None:
            return getattr(self.columns, name)  # frozen by RegistryColumns
        arr = self._snap.get(name)
        if arr is None:
            # snapshot columns the common stages don't need are built
            # lazily (registry updates want eligibility; nothing else)
            vs = self._state.validators
            arr = np.fromiter(
                (v.__dict__[name] for v in vs), dtype=np.uint64, count=self.n
            )
            arr.setflags(write=False)
            self._snap[name] = arr
        # read-only in ALL modes: sweeps that must write a snapshot
        # column go through write_snapshot_rows / refresh_rows
        from ..analysis.sanitizer import freeze_view

        return freeze_view(arr)

    def write_snapshot_rows(self, name: str, idx, values):
        """Sanctioned in-place update of a legacy snapshot column after
        targeted object writebacks. Resident columns never take this
        path — they re-sync from the dirty-channel drain instead (the
        column may be CoW-shared with other state copies)."""
        if self.columns is not None:
            raise ValueError(
                "write_snapshot_rows is for legacy snapshots; resident "
                "columns re-sync via refresh()"
            )
        from ..analysis.sanitizer import writable_window

        with writable_window(self._snap[name]) as buf:
            buf[idx] = values

    @property
    def effective_balance(self) -> np.ndarray:
        return self._col("effective_balance")

    @property
    def activation_eligibility_epoch(self) -> np.ndarray:
        return self._col("activation_eligibility_epoch")

    @property
    def activation_epoch(self) -> np.ndarray:
        return self._col("activation_epoch")

    @property
    def exit_epoch(self) -> np.ndarray:
        return self._col("exit_epoch")

    @property
    def withdrawable_epoch(self) -> np.ndarray:
        return self._col("withdrawable_epoch")

    @property
    def slashed(self) -> np.ndarray:
        return self._col("slashed")

    # -- balances / inactivity scores (the sweep's read-modify-write) ----

    def load_balances(self, state) -> np.ndarray:
        if self.columns is not None:
            # re-sync first: object-path writes since the last refresh
            # (electra queue stages, block ops) must land in the column
            self.columns.refresh(state)
            return self.columns.balances.copy()
        return np.fromiter(state.balances, dtype=np.uint64, count=self.n)

    def store_balances(self, state, new: np.ndarray):
        if self.columns is not None:
            self.columns.write_balances(state, new)
        else:
            state.balances[:] = new.tolist()

    def load_inactivity_scores(self, state) -> np.ndarray:
        if self.columns is not None:
            self.columns.refresh(state)
            return self.columns.inactivity_scores.copy()
        return np.fromiter(
            state.inactivity_scores, dtype=np.uint64, count=self.n
        )

    def store_inactivity_scores(self, state, new: np.ndarray):
        if self.columns is not None:
            self.columns.write_inactivity_scores(state, new)
        else:
            state.inactivity_scores[:] = new.tolist()

    def refresh_rows(self, state, indices):
        """Re-sync specific validators after targeted object mutations
        (registry updates touch a handful of rows). Resident columns
        consume the exact dirty-index drain instead of the caller's
        list; the legacy snapshot re-reads the given rows."""
        if self.columns is not None:
            self.columns.refresh(state)
            return
        from contextlib import ExitStack

        from ..analysis.sanitizer import writable_window

        with ExitStack() as stack:
            snap = {
                name: stack.enter_context(writable_window(arr))
                for name, arr in self._snap.items()
            }
            for i in indices:
                v = state.validators[i]
                snap["effective_balance"][i] = v.effective_balance
                snap["activation_epoch"][i] = v.activation_epoch
                snap["exit_epoch"][i] = v.exit_epoch
                snap["withdrawable_epoch"][i] = v.withdrawable_epoch
                snap["slashed"][i] = v.slashed
                if "activation_eligibility_epoch" in snap:
                    snap["activation_eligibility_epoch"][i] = (
                        v.activation_eligibility_epoch
                    )

    def active_at(self, epoch: int) -> np.ndarray:
        e = np.uint64(epoch)
        return (self.activation_epoch <= e) & (e < self.exit_epoch)

    def total_active_balance(self, epoch: int, E) -> int:
        """Spec get_total_active_balance from the resident columns — the
        1M-object Python sweep the accessor pays, as one masked sum."""
        active = self.active_at(epoch)
        return max(
            int(self.effective_balance[active].sum(dtype=np.uint64)),
            E.EFFECTIVE_BALANCE_INCREMENT,
        )

    def unslashed_participating(self, flag_index: int, epoch_is_prev: bool):
        part = self.prev_participation if epoch_is_prev else self.curr_participation
        flag = np.uint8(1 << flag_index)
        return (part & flag).astype(bool) & ~self.slashed


def get_unslashed_participating_balance(
    arrays: EpochArrays, flag_index: int, epoch_is_prev: bool, active: np.ndarray, E
) -> int:
    mask = arrays.unslashed_participating(flag_index, epoch_is_prev) & active
    total = int(arrays.effective_balance[mask].sum(dtype=np.uint64))
    return max(total, E.EFFECTIVE_BALANCE_INCREMENT)


def process_justification_and_finalization_altair(
    state, E, arrays: EpochArrays | None = None
):
    """Justification totals from participation flags (vectorized), then the
    shared FFG weighing (per_epoch.weigh_justification_and_finalization)."""
    from ..types.chain_spec import GENESIS_EPOCH

    current = get_current_epoch(state, E)
    if current <= GENESIS_EPOCH + 1:
        return
    arrays = arrays or EpochArrays(state, E)
    prev_active = arrays.active_at(get_previous_epoch(state, E))
    curr_active = arrays.active_at(current)
    total_active = max(
        int(arrays.effective_balance[curr_active].sum(dtype=np.uint64)),
        E.EFFECTIVE_BALANCE_INCREMENT,
    )
    previous_target = get_unslashed_participating_balance(
        arrays, TIMELY_TARGET_FLAG_INDEX, True, prev_active, E
    )
    current_target = get_unslashed_participating_balance(
        arrays, TIMELY_TARGET_FLAG_INDEX, False, curr_active, E
    )
    weigh_justification_and_finalization(
        state, total_active, previous_target, current_target, E
    )


def process_inactivity_updates(
    state, spec: ChainSpec, E, arrays: EpochArrays | None = None
):
    from ..types.chain_spec import GENESIS_EPOCH
    from .per_epoch import get_finality_delay

    current = get_current_epoch(state, E)
    if current == GENESIS_EPOCH:
        return
    arrays = arrays or EpochArrays(state, E)
    previous = get_previous_epoch(state, E)
    prev_active = arrays.active_at(previous)
    eligible = prev_active | (
        arrays.slashed & (np.uint64(previous + 1) < arrays.withdrawable_epoch)
    )
    participating = arrays.unslashed_participating(
        TIMELY_TARGET_FLAG_INDEX, True
    ) & prev_active

    scores = arrays.load_inactivity_scores(state)
    dec = eligible & participating
    scores[dec] = sub_u64_saturating(scores[dec], np.uint64(1))
    inc = eligible & ~participating
    scores[inc] = add_u64(scores[inc], np.uint64(spec.inactivity_score_bias))
    if not get_finality_delay(state, E) > E.MIN_EPOCHS_TO_INACTIVITY_PENALTY:
        recovery = np.uint64(spec.inactivity_score_recovery_rate)
        scores[eligible] = sub_u64_saturating(scores[eligible], recovery)
    arrays.store_inactivity_scores(state, scores)


def attestation_flag_deltas(
    state, spec: ChainSpec, E, fork: ForkName, arrays: EpochArrays | None = None
):
    """Per-validator attestation reward/penalty components for the
    PREVIOUS epoch (altair/beacon-chain.md get_flag_index_deltas +
    get_inactivity_penalty_deltas), as unsigned numpy arrays. The epoch
    sweep applies them; the rewards API reports them — one
    implementation, so the endpoint can never drift from the transition.

    Returns (flag_rewards, flag_penalties, inactivity_penalties,
    eligible, info): per-flag lists of uint64 arrays, the inactivity
    penalty array, the eligibility mask, and an `info` dict
    (base_reward_per_increment, total_active_increments,
    upb_increments[flag], in_leak) for ideal-reward reporting."""
    from .per_epoch import get_finality_delay

    arrays = arrays or EpochArrays(state, E)
    current = get_current_epoch(state, E)
    previous = get_previous_epoch(state, E)
    prev_active = arrays.active_at(previous)
    curr_active = arrays.active_at(current)
    eligible = prev_active | (
        arrays.slashed & (np.uint64(previous + 1) < arrays.withdrawable_epoch)
    )

    total_active = max(
        int(arrays.effective_balance[curr_active].sum(dtype=np.uint64)),
        E.EFFECTIVE_BALANCE_INCREMENT,
    )
    base_reward_per_increment = (
        E.EFFECTIVE_BALANCE_INCREMENT * E.BASE_REWARD_FACTOR // int_sqrt(total_active)
    )
    eb_increments = div_u64(
        arrays.effective_balance, np.uint64(E.EFFECTIVE_BALANCE_INCREMENT)
    )
    base_rewards = mul_u64(eb_increments, np.uint64(base_reward_per_increment))
    total_active_increments = total_active // E.EFFECTIVE_BALANCE_INCREMENT

    in_leak = get_finality_delay(state, E) > E.MIN_EPOCHS_TO_INACTIVITY_PENALTY
    flag_rewards: list[np.ndarray] = []
    flag_penalties: list[np.ndarray] = []
    upb_increments_by_flag: list[int] = []

    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        participating = (
            arrays.unslashed_participating(flag_index, True) & prev_active
        )
        upb = max(
            int(arrays.effective_balance[participating].sum(dtype=np.uint64)),
            E.EFFECTIVE_BALANCE_INCREMENT,
        )
        upb_increments = upb // E.EFFECTIVE_BALANCE_INCREMENT
        upb_increments_by_flag.append(upb_increments)
        got_flag = eligible & participating
        reward = np.zeros(arrays.n, dtype=np.uint64)
        penalty = np.zeros(arrays.n, dtype=np.uint64)
        if not in_leak:
            # reward = base * weight * upi // (tai * WD) — u64-exact per
            # _REWARD_RANGE_DOC; mul_u64 proves it lane-wise in sanitize
            numer = mul_u64(
                mul_u64(base_rewards[got_flag], np.uint64(weight)),
                np.uint64(upb_increments),
            )
            reward[got_flag] = div_u64(
                numer, np.uint64(total_active_increments * WEIGHT_DENOMINATOR)
            )
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            missed = eligible & ~participating
            penalty[missed] = div_u64(
                mul_u64(base_rewards[missed], np.uint64(weight)),
                np.uint64(WEIGHT_DENOMINATOR),
            )
        flag_rewards.append(reward)
        flag_penalties.append(penalty)

    # Inactivity penalties (get_inactivity_penalty_deltas)
    scores = arrays.load_inactivity_scores(state)
    participating_target = (
        arrays.unslashed_participating(TIMELY_TARGET_FLAG_INDEX, True) & prev_active
    )
    quotient = (
        E.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX
        if fork >= ForkName.BELLATRIX
        else E.INACTIVITY_PENALTY_QUOTIENT_ALTAIR
    )
    inactive = eligible & ~participating_target
    denom = spec.inactivity_score_bias * quotient
    inactivity = np.zeros(arrays.n, dtype=np.uint64)
    max_score = int(scores.max(initial=0))
    max_eb = int(arrays.effective_balance.max(initial=0))
    if max_score and max_eb and max_score > (1 << 64) // max_eb:
        # effective_balance · score can overflow u64 under very long
        # non-finality (or electra 2048-ETH maxeb): fall back to exact
        # bigint math for the affected lanes instead of aborting the node
        # (r2 advisor finding — the guard used to be a bare assert).
        for i in np.nonzero(inactive)[0]:
            inactivity[i] = np.uint64(
                int(arrays.effective_balance[i]) * int(scores[i]) // denom
            )
    else:
        penalty_numer = mul_u64(
            arrays.effective_balance[inactive], scores[inactive]
        )
        inactivity[inactive] = div_u64(penalty_numer, np.uint64(denom))

    info = {
        "base_reward_per_increment": base_reward_per_increment,
        "total_active_increments": total_active_increments,
        "upb_increments": upb_increments_by_flag,
        "in_leak": in_leak,
        "eb_increments": eb_increments,
    }
    return flag_rewards, flag_penalties, inactivity, eligible, info


def process_rewards_and_penalties_altair(
    state, spec: ChainSpec, E, fork: ForkName, arrays: EpochArrays | None = None
):
    """Flag deltas + inactivity penalties as fused array ops
    (single_pass.rs:20 / altair/beacon-chain.md get_flag_index_deltas)."""
    from ..types.chain_spec import GENESIS_EPOCH

    current = get_current_epoch(state, E)
    if current == GENESIS_EPOCH:
        return
    arrays = arrays or EpochArrays(state, E)
    flag_rewards, flag_penalties, inactivity, _eligible, _info = (
        attestation_flag_deltas(state, spec, E, fork, arrays)
    )
    rewards = np.zeros(arrays.n, dtype=np.uint64)
    penalties = inactivity.copy()
    for reward, penalty in zip(flag_rewards, flag_penalties):
        rewards += reward
        penalties += penalty

    balances = arrays.load_balances(state)
    balances = add_u64(balances, rewards)
    balances = sub_u64_saturating(balances, penalties)
    arrays.store_balances(state, balances)


def process_slashings_altair(state, E, fork: ForkName, arrays: EpochArrays | None = None):
    """Correlated slashing penalties as one bulk balance writeback: the
    (few) matched validators' penalties are computed exactly in Python
    ints (eb//inc · adjusted overflows u64 at electra's 2048-ETH maxeb),
    then applied as a single saturating-sub column store instead of one
    `decrease_balance` list write per index."""
    arrays = arrays or EpochArrays(state, E)
    epoch = get_current_epoch(state, E)
    total_balance = arrays.total_active_balance(epoch, E)
    multiplier = (
        E.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX
        if fork >= ForkName.BELLATRIX
        else E.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR
    )
    adjusted = min(sum(state.slashings) * multiplier, total_balance)
    target_epoch = np.uint64(epoch + E.EPOCHS_PER_SLASHINGS_VECTOR // 2)
    mask = arrays.slashed & (arrays.withdrawable_epoch == target_epoch)
    if not mask.any():
        return
    increment = E.EFFECTIVE_BALANCE_INCREMENT
    penalties = np.zeros(arrays.n, dtype=np.uint64)
    if fork >= ForkName.ELECTRA:
        # EIP-7251: per-increment penalty to stay exact at 2048-ETH maxeb
        # per_increment ≤ increment (adjusted ≤ total), eb//increment ≤
        # 2048 at electra maxeb: the product stays far below 2**64
        per_increment = adjusted // (total_balance // increment)
        for index in np.nonzero(mask)[0]:
            eb = int(arrays.effective_balance[index])
            penalties[index] = per_increment * (eb // increment)
    else:
        for index in np.nonzero(mask)[0]:
            eb = int(arrays.effective_balance[index])
            penalty_numerator = eb // increment * adjusted
            penalties[index] = penalty_numerator // total_balance * increment
    balances = arrays.load_balances(state)
    arrays.store_balances(
        state, sub_u64_saturating(balances, penalties)
    )


def process_participation_flag_updates(state, E):
    from ..ssz.persistent import PersistentByteList

    cur = state.current_epoch_participation
    if isinstance(cur, PersistentByteList):
        # persistent rotation: previous adopts current's blocks AND dirt
        # tokens (coerce takes a CoW copy), current becomes a fresh zero
        # list — then the hash cache and the resident columns rotate
        # their per-field entries along so the committed-token lineage
        # survives the epoch boundary (no full rebuilds, no full diffs
        # on the next block's sparse re-root).
        state.previous_epoch_participation = cur
        state.current_epoch_participation = PersistentByteList(
            bytes(len(state.validators))
        )
        cache = state.__dict__.get("_thc_cache")
        if cache is not None:
            cache.rotate_participation()
        cols = state.__dict__.get("_registry_columns")
        if cols is not None:
            cols.rotate_participation(state)
        return
    state.previous_epoch_participation = bytearray(state.current_epoch_participation)
    state.current_epoch_participation = bytearray(len(state.validators))


def process_sync_committee_updates(state, E):
    next_epoch = get_current_epoch(state, E) + 1
    if next_epoch % E.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = get_next_sync_committee(state, E)


def process_historical_summaries_update(state, E):
    """Capella+: append a HistoricalSummary instead of a HistoricalBatch root
    (capella/beacon-chain.md)."""
    from ..types.containers import build_types

    t = build_types(E)
    next_epoch = get_current_epoch(state, E) + 1
    if next_epoch % (E.SLOTS_PER_HISTORICAL_ROOT // E.SLOTS_PER_EPOCH) == 0:
        from ..ssz.core import Bytes32, Vector

        block_roots_root = Vector[
            Bytes32, E.SLOTS_PER_HISTORICAL_ROOT
        ].hash_tree_root_of(list(state.block_roots))
        state_roots_root = Vector[
            Bytes32, E.SLOTS_PER_HISTORICAL_ROOT
        ].hash_tree_root_of(list(state.state_roots))
        state.historical_summaries.append(
            t.HistoricalSummary(
                block_summary_root=block_roots_root,
                state_summary_root=state_roots_root,
            )
        )


def _device_sweep_applicable(state, arrays: EpochArrays, spec, E) -> bool:
    """The device kernel is u64-exact only while effective_balance·score
    cannot overflow (the numpy path's bigint fallback has no device
    equivalent) and at non-genesis epochs."""
    from ..types.chain_spec import GENESIS_EPOCH

    if get_current_epoch(state, E) == GENESIS_EPOCH:
        return False
    scores_max = int(arrays.load_inactivity_scores(state).max(initial=0))
    eb_max = int(arrays.effective_balance.max(initial=0))
    # scores grow by at most the (spec-configurable) bias in this pass
    margin = int(spec.inactivity_score_bias)
    return not (
        scores_max and eb_max and (scores_max + margin) > (1 << 64) // eb_max
    )


def _device_rewards_and_inactivity(state, spec: ChainSpec, E, fork: ForkName, arrays):
    """The epoch-sweep kernel (ops/epoch_sweep, K7) in place of
    process_inactivity_updates + process_rewards_and_penalties_altair, on
    the default device: the kernel on a card, its plain PyTorch version on
    the CPU device. Bit-exact with the numpy sweep where
    `_device_sweep_applicable` admits the state
    (tests/test_torch_epoch_sweep.py)."""
    from ..ops.epoch_sweep import epoch_sweep_arrays
    from .per_epoch import get_finality_delay

    current = get_current_epoch(state, E)
    previous = get_previous_epoch(state, E)
    curr_active = arrays.active_at(current)
    total_active = max(
        int(arrays.effective_balance[curr_active].sum(dtype=np.uint64)),
        E.EFFECTIVE_BALANCE_INCREMENT,
    )
    quotient = (
        E.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX
        if fork >= ForkName.BELLATRIX
        else E.INACTIVITY_PENALTY_QUOTIENT_ALTAIR
    )
    scalars = np.array(
        [
            previous,
            current,
            E.EFFECTIVE_BALANCE_INCREMENT
            * E.BASE_REWARD_FACTOR
            // int_sqrt(total_active),
            total_active // E.EFFECTIVE_BALANCE_INCREMENT,
            int(get_finality_delay(state, E) > E.MIN_EPOCHS_TO_INACTIVITY_PENALTY),
            spec.inactivity_score_bias,
            spec.inactivity_score_recovery_rate,
            spec.inactivity_score_bias * quotient,
            E.EFFECTIVE_BALANCE_INCREMENT,
        ],
        dtype=np.uint64,
    )
    columns = {
        "effective_balance": arrays.effective_balance,
        "slashed": arrays.slashed,
        "activation_epoch": arrays.activation_epoch,
        "exit_epoch": arrays.exit_epoch,
        "withdrawable_epoch": arrays.withdrawable_epoch,
        "prev_flags": arrays.prev_participation,
        "scores": arrays.load_inactivity_scores(state),
        "balances": arrays.load_balances(state),
    }
    new_balances, new_scores = epoch_sweep_arrays(columns, scalars)
    # ONE bulk device→host transfer each (per-element int() would sync
    # once per validator); the store helpers diff against the resident
    # columns so only changed rows hit the persistent lists
    arrays.store_inactivity_scores(state, new_scores)
    arrays.store_balances(state, new_balances)


def process_epoch_altair(state, spec: ChainSpec, E, fork: ForkName):
    """Altair+ epoch transition (per_epoch_processing/altair.rs:55).

    Runs over the state-resident RegistryColumns when the registry is in
    the persistent (tree-states) representation: zero column rebuilds in
    steady state, all sweeps as array programs, and only vectorized-diff
    writebacks into the lists. Plain-list states take the legacy
    per-validator snapshot path (the retained oracle). Each stage is
    wrapped in an ``epoch_stage_*`` span for the bench breakdown."""
    from ..utils.tracing import span
    from .per_epoch import (
        process_effective_balance_updates,
        process_eth1_data_reset,
        process_historical_roots_update,
        process_randao_mixes_reset,
        process_registry_updates,
        process_slashings_reset,
    )
    from .registry_columns import registry_columns_for

    columns = registry_columns_for(state)
    if columns is not None:
        with span("epoch_stage_columns_refresh"):
            columns.refresh(state)
    arrays = EpochArrays(state, E, columns=columns)
    with span("epoch_stage_justification"):
        process_justification_and_finalization_altair(state, E, arrays)
    if _device_sweep_applicable(state, arrays, spec, E):
        # the sweep kernel wherever the u64 guard admits the state; the
        # numpy sweep at the genesis epoch and where the guard trips
        with span("epoch_stage_rewards"):
            _device_rewards_and_inactivity(state, spec, E, fork, arrays)
    else:
        with span("epoch_stage_inactivity"):
            process_inactivity_updates(state, spec, E, arrays)
        with span("epoch_stage_rewards"):
            process_rewards_and_penalties_altair(state, spec, E, fork, arrays)
    with span("epoch_stage_registry_updates"):
        changed = process_registry_updates(state, spec, E, arrays=arrays)
        # one shared view per epoch: registry updates report the touched
        # rows and the columns re-sync in place (no second full rebuild)
        arrays.refresh_rows(state, changed)
    with span("epoch_stage_slashings"):
        process_slashings_altair(state, E, fork, arrays)
    process_eth1_data_reset(state, E)
    with span("epoch_stage_effective_balances"):
        if fork >= ForkName.ELECTRA:
            electra_not_ported("process_epoch")
        process_effective_balance_updates(state, E, arrays=arrays)
    with span("epoch_stage_final_updates"):
        process_slashings_reset(state, E)
        process_randao_mixes_reset(state, E)
        if fork >= ForkName.CAPELLA:
            process_historical_summaries_update(state, E)
        else:
            process_historical_roots_update(state, E)
        process_participation_flag_updates(state, E)
        process_sync_committee_updates(state, E)
    invalidate_caches(state)
