"""Gossip attestation verification, single and batched.

Mirrors beacon_node/beacon_chain/src/attestation_verification.rs and its
batch module (batch.rs:31,140): unaggregated attestations are indexed via
the committee cache, signature sets built from the decompressed pubkey
cache, then verified in one RLC batch with per-item fallback on failure —
the card offload point for the gossip hot path (SURVEY.md §3.3): the
batch runs on the `cuda` backend when the device is the card.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import bls
from ..metrics import REGISTRY
from ..state_processing import signature_sets as sigsets
from ..state_processing.accessors import (
    committee_cache_at,
    compute_epoch_at_slot,
    get_attesting_indices,
)

# Slot-anchored observation delays (the reference's
# beacon_attestation_gossip_slot_start_delay_time family): how far into
# an attestation's slot it reached US — the input-side latency number the
# import/queue metrics can't see. Buckets span a slot-and-change: the
# propagation window allows attestations several slots old.
_OBS_DELAY_BUCKETS = (
    0.25, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 24.0, 48.0, 96.0,
)
_ATT_OBS_DELAY = REGISTRY.histogram(
    "beacon_attestation_gossip_slot_start_delay_seconds",
    "attestation slot start → gossip verification reached it",
    buckets=_OBS_DELAY_BUCKETS,
)
_AGG_OBS_DELAY = REGISTRY.histogram(
    "beacon_aggregate_gossip_slot_start_delay_seconds",
    "aggregate's slot start → gossip verification reached it",
    buckets=_OBS_DELAY_BUCKETS,
)


class AttestationError(ValueError):
    pass


@dataclass
class VerifiedUnaggregatedAttestation:
    attestation: object
    indexed_attestation: object
    validator_index: int


@dataclass
class VerifiedAggregatedAttestation:
    signed_aggregate: object
    indexed_attestation: object


class AttestationVerifier:
    """Stateless-ish verifier bound to a chain (uses its head state caches,
    observed-caches and clock)."""

    def __init__(self, chain):
        self.chain = chain

    # -- shared structural checks -------------------------------------------

    def _common_checks(self, data):
        chain = self.chain
        E = chain.E
        current_slot = chain.slot_clock.now()
        if data.target.epoch != compute_epoch_at_slot(data.slot, E):
            raise AttestationError("target epoch does not match slot")
        # propagation window: slot within ATTESTATION_PROPAGATION_SLOT_RANGE
        if not (
            data.slot
            <= current_slot
            <= data.slot + chain.spec.attestation_propagation_slot_range
        ):
            raise AttestationError(
                f"attestation slot {data.slot} outside propagation window "
                f"at {current_slot}"
            )
        if not chain.fork_choice.contains_block(data.beacon_block_root):
            raise AttestationError("unknown beacon block root")

    def _indexing_state(self, data):
        """A state able to compute committees for the attestation's epoch
        (the shuffling cache role)."""
        return self.chain.state_for_attestation_epoch(data.target.epoch)

    # -- unaggregated --------------------------------------------------------

    def build_unaggregated(self, attestation):
        """Structural checks + indexing; returns (pre-verification object,
        signature set). Signature NOT yet verified."""
        data = attestation.data
        self._common_checks(data)
        # clamped at 0: clock disparity lets an attestation arrive just
        # before its slot starts — a negative sample would corrupt the
        # histogram's bucket counts and sum
        _ATT_OBS_DELAY.observe(
            max(0.0, self.chain.slot_clock.slot_offset_seconds(int(data.slot)))
        )
        if sum(attestation.aggregation_bits) != 1:
            raise AttestationError("unaggregated attestation must set one bit")
        state = self._indexing_state(data)
        cc = committee_cache_at(state, data.target.epoch, self.chain.E)
        if data.index >= cc.committees_per_slot:
            raise AttestationError("committee index out of range")
        indices = get_attesting_indices(
            state, data, attestation.aggregation_bits, self.chain.E
        )
        validator_index = indices[0]
        if self.chain.observed_attesters.is_known(
            data.target.epoch, validator_index
        ):
            raise AttestationError("validator already attested this epoch")
        indexed = self.chain._indexed_from(state, attestation, indices)
        sig_set = sigsets.indexed_attestation_signature_set(
            state, indexed, self.chain.spec, self.chain.E
        )
        return (
            VerifiedUnaggregatedAttestation(
                attestation=attestation,
                indexed_attestation=indexed,
                validator_index=validator_index,
            ),
            sig_set,
        )

    def verify_unaggregated(self, attestation) -> VerifiedUnaggregatedAttestation:
        verified, sig_set = self.build_unaggregated(attestation)
        if not sig_set.verify():
            raise AttestationError("invalid attestation signature")
        self.chain.observed_attesters.observe(
            attestation.data.target.epoch, verified.validator_index
        )
        return verified

    def batch_verify_unaggregated(self, attestations) -> list:
        """One RLC batch across the whole gossip batch; on failure, falls
        back to per-item verification (batch.rs:205-221). Returns a list of
        VerifiedUnaggregatedAttestation | AttestationError."""
        prepared = []
        results: list = [None] * len(attestations)
        seen_in_batch: set[tuple[int, int]] = set()
        for i, att in enumerate(attestations):
            try:
                verified, sig_set = self.build_unaggregated(att)
                # intra-batch dedup: the observed cache only updates after
                # verification, so duplicates inside one batch need catching
                key = (att.data.target.epoch, verified.validator_index)
                if key in seen_in_batch:
                    raise AttestationError(
                        "validator already attested this epoch"
                    )
                seen_in_batch.add(key)
                prepared.append((i, verified, sig_set))
            except AttestationError as e:
                results[i] = e
        sets = [s for (_, _, s) in prepared]
        if sets and bls.verify_signature_sets(sets):
            for i, verified, _ in prepared:
                self.chain.observed_attesters.observe(
                    verified.attestation.data.target.epoch,
                    verified.validator_index,
                )
                results[i] = verified
        else:
            for i, verified, sig_set in prepared:
                if sig_set.verify():
                    self.chain.observed_attesters.observe(
                        verified.attestation.data.target.epoch,
                        verified.validator_index,
                    )
                    results[i] = verified
                else:
                    results[i] = AttestationError("invalid attestation signature")
        return results

    # -- aggregated ----------------------------------------------------------

    def verify_aggregated(self, signed_aggregate) -> VerifiedAggregatedAttestation:
        """Three signature sets per aggregate: selection proof, aggregator
        signature, aggregate attestation (batch.rs:78-108)."""
        chain = self.chain
        message = signed_aggregate.message
        aggregate = message.aggregate
        data = aggregate.data
        self._common_checks(data)
        _AGG_OBS_DELAY.observe(  # clamped: see batch_verify_unaggregated
            max(0.0, self.chain.slot_clock.slot_offset_seconds(int(data.slot)))
        )
        if sum(aggregate.aggregation_bits) == 0:
            raise AttestationError("empty aggregate")
        state = self._indexing_state(data)
        cc = committee_cache_at(state, data.target.epoch, chain.E)
        if data.index >= cc.committees_per_slot:
            raise AttestationError("committee index out of range")
        committee = cc.committee(data.slot, data.index)
        if message.aggregator_index not in committee:
            raise AttestationError("aggregator not in committee")
        if not is_aggregator(
            len(committee), message.selection_proof, chain.E
        ):
            raise AttestationError("validator is not an aggregator for this slot")
        if chain.observed_aggregators.is_known(
            data.target.epoch, message.aggregator_index
        ):
            raise AttestationError("aggregator already seen this epoch")
        indices = get_attesting_indices(
            state, data, aggregate.aggregation_bits, chain.E
        )
        indexed = chain._indexed_from(state, aggregate, indices)
        sets = [
            sigsets.selection_proof_signature_set(
                state,
                message.aggregator_index,
                data.slot,
                message.selection_proof,
                chain.spec,
                chain.E,
            ),
            sigsets.aggregate_and_proof_signature_set(
                state, signed_aggregate, chain.spec, chain.E
            ),
            sigsets.indexed_attestation_signature_set(
                state, indexed, chain.spec, chain.E
            ),
        ]
        if not bls.verify_signature_sets(sets):
            raise AttestationError("invalid aggregate signatures")
        chain.observed_aggregators.observe(
            data.target.epoch, message.aggregator_index
        )
        return VerifiedAggregatedAttestation(
            signed_aggregate=signed_aggregate, indexed_attestation=indexed
        )


TARGET_AGGREGATORS_PER_COMMITTEE = 16


def is_aggregator(committee_len: int, selection_proof: bytes, E) -> bool:
    """Spec is_aggregator: hash of the selection proof selects ~16 per
    committee."""
    from ..utils.hash import sha256

    modulo = max(1, committee_len // TARGET_AGGREGATORS_PER_COMMITTEE)
    return (
        int.from_bytes(sha256(bytes(selection_proof))[:8], "little") % modulo == 0
    )


class ObservedCache:
    """(epoch, index) dedup cache with pruning — the observed_attesters /
    observed_aggregates family (beacon_chain/src/observed_attesters.rs)."""

    def __init__(self):
        self._seen: dict[int, set[int]] = {}

    def is_known(self, epoch: int, index: int) -> bool:
        return index in self._seen.get(epoch, ())

    def observe(self, epoch: int, index: int):
        self._seen.setdefault(epoch, set()).add(index)

    def prune(self, finalized_epoch: int):
        for e in [e for e in self._seen if e < finalized_epoch]:
            del self._seen[e]
