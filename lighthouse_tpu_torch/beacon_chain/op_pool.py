"""Operation pool: attestations/slashings/exits for block production.

Mirrors beacon_node/operation_pool: attestations aggregated per
AttestationData, greedy max-cover packing for block inclusion
(max_cover.rs / attestation.rs AttMaxCover), SSZ persistence hooks.

Unaggregated-attestation indexing is columnar: attestations group by
AttestationData root AT INSERT into `_AttBucket`s that keep every
aggregation pattern resident as a numpy bool row plus the bucket's
running bitmask union — the greedy in-place aggregation (merge into the
first disjoint stored aggregate) happens against those masks, so
`get_attestations_for_block` starts from pre-unioned candidates with
pre-decoded masks instead of re-hashing and re-decoding the raw pool:
its max-cover runs as a flat array program (one gains vector, np.argmax
per round, per-bucket coverage rows; a pick only dents its own bucket's
gains, so nothing else recomputes). The pre-columnar pack walk is
retained verbatim as `get_attestations_for_block_reference` — the
differential oracle and the `op_pool_pack_ms` bench control.
"""

from __future__ import annotations

import numpy as np

from ..crypto import bls
from ..state_processing.accessors import (
    compute_epoch_at_slot,
    get_current_epoch,
    get_previous_epoch,
)


class _AttBucket:
    """All pooled aggregates for one AttestationData: the shared `data`,
    its slot (pruning key), the attestation objects, their aggregation
    bitmasks as resident numpy bool rows (parallel to `atts`), a
    bytes-key set for exact-duplicate rejection, and the running union of
    every mask ever inserted (the pre-unioned coverage ceiling)."""

    __slots__ = ("data", "slot", "atts", "masks", "keys", "union_mask")

    def __init__(self, data, slot: int, nbits: int):
        self.data = data
        self.slot = slot
        self.atts: list = []
        self.masks: list[np.ndarray] = []
        self.keys: set[bytes] = set()
        self.union_mask = np.zeros(nbits, dtype=bool)

    def append(self, attestation, mask: np.ndarray):
        self.atts.append(attestation)
        self.masks.append(mask)
        self.keys.add(mask.tobytes())
        self.union_mask |= mask

    def replace(self, j: int, attestation, mask: np.ndarray):
        """Drop aggregate j and install its merged successor — at the end
        when the merged mask is new (the scalar dict's del-then-insert
        ordering), or OVER the existing equal-mask entry when the merge
        reproduced one (the dict assignment's dedup: the bucket must
        never hold two aggregates with identical masks)."""
        old = self.masks.pop(j)
        self.atts.pop(j)
        self.keys.discard(old.tobytes())
        key = mask.tobytes()
        if key in self.keys:
            for pos, m in enumerate(self.masks):
                if m.tobytes() == key:
                    self.atts[pos] = attestation
                    self.masks[pos] = mask
                    return
        self.append(attestation, mask)


class OperationPool:
    def __init__(self, spec, E):
        self.spec = spec
        self.E = E
        # data_root -> _AttBucket; kept disaggregated enough to
        # re-aggregate disjoint sets at packing time
        self._attestations: dict[bytes, _AttBucket] = {}
        self._proposer_slashings: dict[int, object] = {}
        self._attester_slashings: list = []
        self._voluntary_exits: dict[int, object] = {}

    # -- insert -------------------------------------------------------------

    # Max running aggregates kept per AttestationData (bounds memory; the
    # reference's naive aggregation pool keeps one per data + overlap spill).
    MAX_AGGREGATES_PER_DATA = 16

    def _bucket_for(self, attestation, mask: np.ndarray) -> _AttBucket:
        data_root = attestation.data.hash_tree_root()
        bucket = self._attestations.get(data_root)
        if bucket is None:
            bucket = _AttBucket(
                attestation.data, int(attestation.data.slot), mask.size
            )
            self._attestations[data_root] = bucket
        return bucket

    def insert_attestation(self, attestation):
        """Greedy in-place aggregation: merge into the first disjoint stored
        aggregate (replacing it), else keep standalone up to a cap — linear
        mask work per insert, no combinatorial growth."""
        mask = np.asarray(attestation.aggregation_bits, dtype=bool)
        bucket = self._bucket_for(attestation, mask)
        if mask.tobytes() in bucket.keys:
            return
        for j, other_mask in enumerate(bucket.masks):
            if mask.size == other_mask.size and not bool(
                (mask & other_mask).any()
            ):
                merged_mask = mask | other_mask
                agg = bls.AggregateSignature.from_signatures(
                    [
                        bls.Signature(attestation.signature),
                        bls.Signature(bucket.atts[j].signature),
                    ]
                )
                t = type(attestation)
                merged = t(
                    aggregation_bits=merged_mask.tolist(),
                    data=attestation.data,
                    signature=agg.to_signature().to_bytes(),
                )
                bucket.replace(j, merged, merged_mask)
                return
        if len(bucket.atts) < self.MAX_AGGREGATES_PER_DATA:
            bucket.append(attestation, mask)

    def _add_unmerged(self, attestation):
        """Insert WITHOUT the disjoint-merge scan (tests and pool-building
        fixtures that need exact aggregation patterns preserved)."""
        mask = np.asarray(attestation.aggregation_bits, dtype=bool)
        bucket = self._bucket_for(attestation, mask)
        if mask.tobytes() in bucket.keys:
            return
        if len(bucket.atts) < self.MAX_AGGREGATES_PER_DATA:
            bucket.append(attestation, mask)

    def get_aggregate(self, data_root: bytes):
        """Best (highest-participation) running aggregate for an
        AttestationData root — the get_aggregate_attestation API surface
        aggregators read (naive aggregation pool `get`)."""
        bucket = self._attestations.get(bytes(data_root))
        if bucket is None or not bucket.atts:
            return None
        sums = [int(m.sum()) for m in bucket.masks]
        return bucket.atts[max(range(len(sums)), key=sums.__getitem__)]

    def insert_proposer_slashing(self, slashing):
        self._proposer_slashings[
            slashing.signed_header_1.message.proposer_index
        ] = slashing

    #: bound on distinct pooled attester slashings (gossip flood guard)
    MAX_ATTESTER_SLASHINGS_POOLED = 128

    @staticmethod
    def _slashable_indices(asl) -> set:
        return set(asl.attestation_1.attesting_indices) & set(
            asl.attestation_2.attesting_indices
        )

    def insert_attester_slashing(self, slashing):
        """Pool only slashings that cover at least one validator no pooled
        slashing already covers — overlapping entries would pack together
        and fail the block's slashed_any check."""
        new = self._slashable_indices(slashing)
        covered: set = set()
        for asl in self._attester_slashings:
            covered |= self._slashable_indices(asl)
        if not (new - covered):
            return
        if len(self._attester_slashings) >= self.MAX_ATTESTER_SLASHINGS_POOLED:
            return
        self._attester_slashings.append(slashing)

    def insert_voluntary_exit(self, exit_):
        self._voluntary_exits[exit_.message.validator_index] = exit_

    # -- packing ------------------------------------------------------------

    def _bucket_includable(self, state, bucket: _AttBucket, current, previous):
        """The per-AttestationData inclusion filters (epoch, inclusion
        window, FFG source) — checked ONCE per bucket instead of once per
        pooled aggregate."""
        E = self.E
        data = bucket.data
        epoch = data.target.epoch
        if epoch not in (current, previous):
            return False
        if not (
            data.slot + E.MIN_ATTESTATION_INCLUSION_DELAY
            <= state.slot
            <= data.slot + E.SLOTS_PER_EPOCH
        ):
            return False
        return (
            data.source == state.current_justified_checkpoint
            if epoch == current
            else data.source == state.previous_justified_checkpoint
        )

    def get_attestations_for_block(self, state) -> list:
        """Greedy max-cover as a flat array program: one [n_candidates]
        gains vector over the resident bucket masks, np.argmax per round,
        per-bucket coverage rows. Coverage is per AttestationData, so a
        pick only invalidates its OWN bucket's gains — every other
        candidate's gain is untouched, and a round is argmax + one ≤16-row
        recompute instead of a full-pool rescan
        (operation_pool/src/max_cover.rs)."""
        E = self.E
        current = get_current_epoch(state, E)
        previous = get_previous_epoch(state, E)
        buckets = [
            b
            for b in self._attestations.values()
            if b.atts and self._bucket_includable(state, b, current, previous)
        ]
        if not buckets:
            return []
        counts = [len(b.atts) for b in buckets]
        n_cand = sum(counts)
        width = max(b.union_mask.size for b in buckets)
        matrix = np.zeros((n_cand, width), dtype=bool)
        starts = np.zeros(len(buckets) + 1, dtype=np.int64)
        atts_flat: list = []
        pos = 0
        for bi, b in enumerate(buckets):
            k = counts[bi]
            w = b.union_mask.size
            matrix[pos : pos + k, :w] = np.stack(b.masks)
            atts_flat.extend(b.atts)
            starts[bi + 1] = pos + k
            pos += k
        owner_of = np.repeat(np.arange(len(buckets)), counts)
        gains = matrix.sum(axis=1).astype(np.int64)
        covered = np.zeros((len(buckets), width), dtype=bool)
        taken: list[int] = []
        chosen: list = []
        while len(chosen) < E.MAX_ATTESTATIONS:
            best = int(np.argmax(gains))
            if gains[best] <= 0:
                break
            chosen.append(atts_flat[best])
            taken.append(best)
            bi = int(owner_of[best])
            covered[bi] |= matrix[best]
            members = slice(int(starts[bi]), int(starts[bi + 1]))
            gains[members] = (matrix[members] & ~covered[bi]).sum(axis=1)
            gains[taken] = -1
        return chosen

    def get_attestations_for_block_reference(self, state) -> list:
        """The pre-columnar pack walk, retained verbatim: re-hashes every
        candidate's data root and re-decodes its bits, then recomputes the
        FULL gains list every round (the per-pool rescan the flat pack
        replaced). Differential oracle + `op_pool_pack_ms` bench control —
        do not optimize."""
        E = self.E
        current = get_current_epoch(state, E)
        previous = get_previous_epoch(state, E)
        candidates = []
        for bucket in self._attestations.values():
            for att in bucket.atts:
                data = att.data
                epoch = data.target.epoch
                if epoch not in (current, previous):
                    continue
                if not (
                    data.slot + E.MIN_ATTESTATION_INCLUSION_DELAY
                    <= state.slot
                    <= data.slot + E.SLOTS_PER_EPOCH
                ):
                    continue
                source_ok = (
                    data.source == state.current_justified_checkpoint
                    if epoch == current
                    else data.source == state.previous_justified_checkpoint
                )
                if source_ok:
                    candidates.append(att)

        # (data_root, attestation, bits) triples — roots hashed and bit
        # lists decoded per pack; per-round gains are boolean kernels over
        # numpy masks recomputed for EVERY remaining candidate
        keyed = [
            (
                att.data.hash_tree_root(),
                att,
                np.asarray(att.aggregation_bits, dtype=bool),
            )
            for att in candidates
        ]
        chosen: list = []
        covered: dict[bytes, np.ndarray] = {}  # data_root -> covered mask
        while keyed and len(chosen) < E.MAX_ATTESTATIONS:
            gains = [
                int(bits.sum())
                if (cov := covered.get(dr)) is None
                else int(np.count_nonzero(bits & ~cov))
                for dr, _, bits in keyed
            ]
            best_i = max(range(len(keyed)), key=gains.__getitem__)
            if gains[best_i] == 0:
                break
            dr, att, bits = keyed.pop(best_i)
            chosen.append(att)
            cov = covered.get(dr)
            covered[dr] = bits.copy() if cov is None else (cov | bits)
        return chosen

    def get_slashings_and_exits(self, state) -> tuple[list, list, list]:
        """Only operations still applicable on `state` are packed (the
        reference filters against the state at packing time,
        operation_pool/src/lib.rs)."""
        from ..state_processing.accessors import (
            is_slashable_validator,
        )
        from ..types.chain_spec import FAR_FUTURE_EPOCH

        E = self.E
        epoch = get_current_epoch(state, E)
        n_vals = len(state.validators)

        proposer_slashings = [
            ps
            for idx, ps in self._proposer_slashings.items()
            if idx < n_vals and is_slashable_validator(state.validators[idx], epoch)
        ][: E.MAX_PROPOSER_SLASHINGS]

        # greedy pick tracking which validators this block will already
        # slash — two overlapping slashings in one block fail the spec's
        # slashed_any requirement on the second
        attester_slashings = []
        to_be_slashed: set = set()
        for asl in self._attester_slashings:
            if len(attester_slashings) >= E.MAX_ATTESTER_SLASHINGS:
                break
            fresh = {
                i
                for i in self._slashable_indices(asl)
                if i < n_vals
                and is_slashable_validator(state.validators[i], epoch)
                and i not in to_be_slashed
            }
            if fresh:
                attester_slashings.append(asl)
                to_be_slashed |= fresh

        exits = [
            ex
            for idx, ex in self._voluntary_exits.items()
            if idx < n_vals
            and state.validators[idx].exit_epoch == FAR_FUTURE_EPOCH
        ][: E.MAX_VOLUNTARY_EXITS]
        return proposer_slashings, attester_slashings, exits

    # -- pruning ------------------------------------------------------------

    def prune(self, state):
        """Drop operations no longer includable (prune_all analog)."""
        from ..state_processing.accessors import is_slashable_validator
        from ..types.chain_spec import FAR_FUTURE_EPOCH

        E = self.E
        previous = get_previous_epoch(state, E)
        stale = [
            dr
            for dr, bucket in self._attestations.items()
            if compute_epoch_at_slot(bucket.slot, E) < previous
        ]
        for dr in stale:
            self._attestations.pop(dr, None)

        epoch = get_current_epoch(state, E)
        n_vals = len(state.validators)
        for idx in [
            i
            for i in self._proposer_slashings
            if i >= n_vals or not is_slashable_validator(state.validators[i], epoch)
        ]:
            del self._proposer_slashings[idx]
        for idx in [
            i
            for i, _ in self._voluntary_exits.items()
            if i >= n_vals or state.validators[i].exit_epoch != FAR_FUTURE_EPOCH
        ]:
            del self._voluntary_exits[idx]
        self._attester_slashings = [
            asl
            for asl in self._attester_slashings
            if any(
                i < n_vals and is_slashable_validator(state.validators[i], epoch)
                for i in set(asl.attestation_1.attesting_indices)
                & set(asl.attestation_2.attesting_indices)
            )
        ]

    def num_attestations(self) -> int:
        return sum(len(b.atts) for b in self._attestations.values())
