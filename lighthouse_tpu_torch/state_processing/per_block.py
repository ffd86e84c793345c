"""Block processing: the spec `per_block_processing` with signature strategies.

Counterpart of lighthouse_tpu/state_processing/per_block.py, copied.

Mirrors consensus/state_processing/src/per_block_processing.rs:100-196 and its
`BlockSignatureStrategy` (:54-63): NoVerification / VerifyIndividual /
VerifyRandao / VerifyBulk. Bulk mode collects every signature in the block
into one batch and verifies it with a single random-linear-combination
multi-pairing (block_signature_verifier.rs:74-405) — the path the TPU batch
kernels accelerate.
"""

from __future__ import annotations

from enum import Enum

from ..crypto import bls
from ..types.chain_spec import FAR_FUTURE_EPOCH, ChainSpec, Domain
from ..utils.hash import hash32_concat
from ..utils.tracing import span
from . import signature_sets as sigsets
from .accessors import (
    committee_cache_at,
    compute_epoch_at_slot,
    decrease_balance,
    get_attesting_indices,
    get_beacon_committee,
    get_beacon_proposer_index,
    get_committee_count_per_slot,
    get_current_epoch,
    get_indexed_attestation,
    get_previous_epoch,
    get_randao_mix,
    hash_bytes,
    increase_balance,
    initiate_validator_exit,
    is_slashable_attestation_data,
    is_slashable_validator,
    slash_validator,
)

DEPOSIT_CONTRACT_TREE_DEPTH = 32


class BlockProcessingError(ValueError):
    pass


class BlockSignatureStrategy(Enum):
    NO_VERIFICATION = "no_verification"
    VERIFY_INDIVIDUAL = "verify_individual"
    VERIFY_RANDAO = "verify_randao"
    VERIFY_BULK = "verify_bulk"


class ConsensusContext:
    """Memoizes proposer index / block root / indexed attestations across
    verification and processing (consensus_context.rs:12-26)."""

    def __init__(self, slot: int):
        self.slot = slot
        self._proposer_index: int | None = None
        self._block_root: bytes | None = None
        self._indexed_attestations: dict = {}

    def get_proposer_index(self, state, E) -> int:
        if self._proposer_index is None:
            self._proposer_index = get_beacon_proposer_index(state, E)
        return self._proposer_index

    def set_proposer_index(self, index: int):
        self._proposer_index = index

    def get_block_root(self, block) -> bytes:
        if self._block_root is None:
            self._block_root = block.hash_tree_root()
        return self._block_root

    def get_indexed_attestation(self, state, attestation, E):
        # Keyed by object identity: within one block's verification +
        # processing the same attestation objects flow through both passes
        # and stay alive for the context's lifetime.
        key = id(attestation)
        cached = self._indexed_attestations.get(key)
        if cached is None:
            cached = get_indexed_attestation(state, attestation, E)
            self._indexed_attestations[key] = cached
        return cached

    def peek_indexed_attestation(self, attestation):
        """The memoized indexed attestation, or None — the batched
        attestation pipeline checks before assembling its own from the
        columnar committee gather."""
        return self._indexed_attestations.get(id(attestation))

    def set_indexed_attestation(self, attestation, indexed):
        """Memoize an indexed attestation assembled elsewhere (the batch
        pipeline), so signature verification, fork choice and the slasher
        feed reuse the same arrays instead of re-deriving committees."""
        self._indexed_attestations[id(attestation)] = indexed


# ---------------------------------------------------------------------------
# Signature verification
# ---------------------------------------------------------------------------


def is_valid_indexed_attestation(
    state, indexed, spec: ChainSpec, E, verify_signature: bool = True
) -> bool:
    indices = list(indexed.attesting_indices)
    if not indices or indices != sorted(set(indices)):
        return False
    if any(i >= len(state.validators) for i in indices):
        return False
    if not verify_signature:
        return True
    return sigsets.indexed_attestation_signature_set(state, indexed, spec, E).verify()


class BlockSignatureVerifier:
    """Collects every signature set in a block, verifies in one batch
    (block_signature_verifier.rs:74-405)."""

    def __init__(self, state, spec: ChainSpec, E):
        self.state = state
        self.spec = spec
        self.E = E
        self.sets: list[bls.SignatureSet] = []

    def include_block_proposal(self, signed_block, block_root=None):
        self.sets.append(
            sigsets.block_proposal_signature_set(
                self.state, signed_block, block_root, self.spec, self.E
            )
        )

    def include_randao_reveal(self, block):
        self.sets.append(
            sigsets.randao_signature_set(self.state, block, self.spec, self.E)
        )

    def include_proposer_slashings(self, block):
        for ps in block.body.proposer_slashings:
            self.sets.append(
                sigsets.block_header_signature_set(
                    self.state, ps.signed_header_1, self.spec, self.E
                )
            )
            self.sets.append(
                sigsets.block_header_signature_set(
                    self.state, ps.signed_header_2, self.spec, self.E
                )
            )

    def include_attester_slashings(self, block):
        for asl in block.body.attester_slashings:
            for indexed in (asl.attestation_1, asl.attestation_2):
                self.sets.append(
                    sigsets.indexed_attestation_signature_set(
                        self.state, indexed, self.spec, self.E
                    )
                )

    def include_attestations(self, block, ctxt: ConsensusContext):
        for att in block.body.attestations:
            indexed = ctxt.get_indexed_attestation(self.state, att, self.E)
            self.sets.append(
                sigsets.indexed_attestation_signature_set(
                    self.state, indexed, self.spec, self.E
                )
            )

    def include_exits(self, block):
        for exit_ in block.body.voluntary_exits:
            self.sets.append(
                sigsets.exit_signature_set(self.state, exit_, self.spec, self.E)
            )

    def include_sync_aggregate(self, block):
        """Altair+: one set over the participating sync-committee pubkeys.
        The empty-participation case must carry the infinity signature and
        contributes no set (blst.rs fast-aggregate rules)."""
        aggregate = getattr(block.body, "sync_aggregate", None)
        if aggregate is None:
            return
        if not any(aggregate.sync_committee_bits):
            if not bls.Signature(aggregate.sync_committee_signature).is_infinity():
                raise BlockProcessingError(
                    "sync aggregate: empty participation requires infinity sig"
                )
            return
        from .altair import sync_aggregate_signature_set

        self.sets.append(
            sync_aggregate_signature_set(
                self.state, aggregate, block.slot, self.spec, self.E
            )
        )

    def include_bls_to_execution_changes(self, block):
        for change in getattr(block.body, "bls_to_execution_changes", []) or []:
            from .capella import bls_to_execution_change_signature_set

            self.sets.append(
                bls_to_execution_change_signature_set(
                    self.state, change, self.spec, self.E
                )
            )

    def include_all_signatures(self, signed_block, block_root, ctxt):
        self.include_block_proposal(signed_block, block_root)
        self.include_all_signatures_except_proposal(signed_block.message, ctxt)

    def include_all_signatures_except_proposal(self, block, ctxt):
        self.include_randao_reveal(block)
        self.include_proposer_slashings(block)
        self.include_attester_slashings(block)
        self.include_attestations(block, ctxt)
        self.include_exits(block)
        self.include_sync_aggregate(block)
        self.include_bls_to_execution_changes(block)

    def verify(self) -> bool:
        if not self.sets:
            return True
        return bls.verify_signature_sets(self.sets)


# ---------------------------------------------------------------------------
# per_block_processing
# ---------------------------------------------------------------------------


def per_block_processing(
    state,
    signed_block,
    spec: ChainSpec,
    E,
    strategy: BlockSignatureStrategy = BlockSignatureStrategy.VERIFY_BULK,
    ctxt: ConsensusContext | None = None,
    block_root: bytes | None = None,
    verify_block_root: bool = True,
    proposal_already_verified: bool = False,
    execution_engine=None,
    milestones=None,
):
    """Apply `signed_block` to `state` in place. Raises BlockProcessingError
    on ANY invalid condition (per_block_processing.rs:100) — malformed
    indices/slots surface as BlockProcessingError, never as raw
    IndexError/ValueError (the reference's fallible set constructors return
    ValidatorUnknown etc.). `proposal_already_verified` skips the proposer
    signature (the SignatureVerifiedBlock::from_gossip_verified_block path,
    block_verification.rs:1084). `milestones` is an optional callback
    (`milestones("signature_verified")`, `milestones("payload_verified")`)
    the chain uses to stamp its BlockTimesCache at the exact pipeline
    points — the latency-attribution seam, not a behavior hook."""
    try:
        _per_block_processing_inner(
            state, signed_block, spec, E, strategy, ctxt, block_root,
            verify_block_root, proposal_already_verified, execution_engine,
            milestones,
        )
    except BlockProcessingError:
        raise
    except (IndexError, KeyError, ValueError, OverflowError) as e:
        raise BlockProcessingError(f"malformed block: {e}") from e


def _per_block_processing_inner(
    state, signed_block, spec, E, strategy, ctxt, block_root,
    verify_block_root, proposal_already_verified, execution_engine=None,
    milestones=None,
):
    block = signed_block.message
    if ctxt is None:
        ctxt = ConsensusContext(block.slot)

    verify_signatures = strategy in (
        BlockSignatureStrategy.VERIFY_INDIVIDUAL,
        BlockSignatureStrategy.VERIFY_BULK,
    )

    if strategy == BlockSignatureStrategy.VERIFY_BULK:
        verifier = BlockSignatureVerifier(state, spec, E)
        # assembly span: message/domain derivation + pubkey decompression
        # (served by the bls decompression caches after the first block)
        with span("signature_set_assembly"):
            if proposal_already_verified:
                verifier.include_all_signatures_except_proposal(
                    signed_block.message, ctxt
                )
            else:
                verifier.include_all_signatures(signed_block, block_root, ctxt)
        # own span: the signature batch is the stage the TPU backend
        # accelerates, so bench_block_import can price it separately from
        # the rest of the (enclosing) state_transition span; the host
        # backend nests bls_rlc_accumulate/bls_hash_to_g2/bls_pairing
        # stage spans inside this one
        with span("signature_batch_verify", sets=len(verifier.sets)):
            sigs_ok = verifier.verify()
        if not sigs_ok:
            raise BlockProcessingError("bulk signature verification failed")
        # Signatures are done; the per-operation code skips them.
        verify_signatures = False
    elif strategy == BlockSignatureStrategy.VERIFY_INDIVIDUAL:
        if not proposal_already_verified and not sigsets.block_proposal_signature_set(
            state, signed_block, block_root, spec, E
        ).verify():
            raise BlockProcessingError("invalid proposer signature")
    elif strategy == BlockSignatureStrategy.VERIFY_RANDAO:
        pass  # randao handled in process_randao below
    if milestones is not None:
        # signatures settled (verified here, or pre-verified upstream for
        # the NO_VERIFICATION segment path)
        milestones("signature_verified")

    from ..types.chain_spec import ForkName
    from ..types.containers import build_types

    fork = build_types(E).fork_of_state(state)

    process_block_header(state, block, ctxt, E)
    if fork >= ForkName.BELLATRIX:
        from .bellatrix import is_execution_enabled, process_execution_payload

        if is_execution_enabled(state, block.body):
            # Capella+: withdrawals are processed only when execution is
            # enabled (capella/beacon-chain.md process_block).
            if fork >= ForkName.CAPELLA:
                from .capella import process_withdrawals

                process_withdrawals(
                    state, block.body.execution_payload, E, spec=spec
                )
            process_execution_payload(
                state, block.body, spec, E, fork, engine=execution_engine
            )
    if milestones is not None:
        # pre-merge / payload-free blocks verify trivially — the milestone
        # still lands so the slot-anchored chain is complete on every fork
        milestones("payload_verified")
    process_randao(
        state,
        block,
        spec,
        E,
        verify=verify_signatures
        or strategy == BlockSignatureStrategy.VERIFY_RANDAO,
    )
    process_eth1_data(state, block.body.eth1_data, E)
    process_operations(
        state, block.body, spec, E, verify_signatures, ctxt, fork
    )
    if fork >= ForkName.ALTAIR:
        from .altair import process_sync_aggregate

        process_sync_aggregate(
            state, block.body.sync_aggregate, spec, E, verify_signatures, ctxt
        )

    if verify_block_root:
        expected = state.hash_tree_root()
        if block.state_root != expected:
            raise BlockProcessingError(
                f"state root mismatch: block {block.state_root.hex()} != "
                f"computed {expected.hex()}"
            )


def process_block_header(state, block, ctxt: ConsensusContext, E):
    if block.slot != state.slot:
        raise BlockProcessingError(
            f"block slot {block.slot} != state slot {state.slot}"
        )
    if block.slot <= state.latest_block_header.slot:
        raise BlockProcessingError("block older than latest block header")
    expected_proposer = ctxt.get_proposer_index(state, E)
    if block.proposer_index != expected_proposer:
        raise BlockProcessingError(
            f"wrong proposer: {block.proposer_index} != {expected_proposer}"
        )
    if block.parent_root != state.latest_block_header.hash_tree_root():
        raise BlockProcessingError("parent root mismatch")
    from ..types.containers import build_types

    t = build_types(E)
    state.latest_block_header = t.BeaconBlockHeader(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=b"\x00" * 32,  # overwritten at next slot processing
        body_root=block.body.hash_tree_root(),
    )
    proposer = state.validators[block.proposer_index]
    if proposer.slashed:
        raise BlockProcessingError("proposer is slashed")


def process_randao(state, block, spec: ChainSpec, E, verify: bool):
    epoch = get_current_epoch(state, E)
    if verify:
        if not sigsets.randao_signature_set(state, block, spec, E).verify():
            raise BlockProcessingError("invalid randao reveal")
    mix = bytes(
        a ^ b
        for a, b in zip(
            get_randao_mix(state, epoch, E), hash_bytes(block.body.randao_reveal)
        )
    )
    state.randao_mixes[epoch % E.EPOCHS_PER_HISTORICAL_VECTOR] = mix


def eth1_data_vote_count_scan(state, eth1_data) -> int:
    """The original linear SSZ-equality scan over the votes list —
    retained as the differential oracle for the serialized-bytes tally."""
    return state.eth1_data_votes.count(eth1_data)


def _eth1_vote_tally(state) -> dict:
    """Per-state serialized-bytes tally of eth1_data_votes, kept alongside
    the list so each block pays one dict bump instead of an O(votes)
    container-equality scan. Eth1Data is fixed-size with bijective
    serialization, so byte equality IS SSZ equality. The tally lives
    outside the SSZ fields (state.copy() drops it; a copy rebuilds
    lazily) and is invalidated whenever the votes list is replaced or
    its length moved without us (period-boundary reset, replayed
    states)."""
    votes = state.eth1_data_votes
    tally = state.__dict__.get("_lh_eth1_tally")
    if (
        tally is None
        or tally["list_id"] != id(votes)
        or tally["len"] != len(votes)
    ):
        counts: dict[bytes, int] = {}
        for v in votes:
            key = v.serialize()
            counts[key] = counts.get(key, 0) + 1
        tally = {"list_id": id(votes), "len": len(votes), "counts": counts}
        state.__dict__["_lh_eth1_tally"] = tally
    return tally


def process_eth1_data(state, eth1_data, E):
    tally = _eth1_vote_tally(state)
    state.eth1_data_votes.append(eth1_data)
    key = eth1_data.serialize()
    tally["counts"][key] = tally["counts"].get(key, 0) + 1
    tally["len"] = len(state.eth1_data_votes)
    if tally["counts"][key] * 2 > E.slots_per_eth1_voting_period():
        state.eth1_data = eth1_data


def process_operations(
    state,
    body,
    spec: ChainSpec,
    E,
    verify_signatures: bool,
    ctxt: ConsensusContext,
    fork=None,
):
    from ..types.chain_spec import ForkName

    if fork is None:
        from ..types.containers import build_types

        fork = build_types(E).fork_of_state(state)
    # Deposit count check. Electra (EIP-6110): eth1-bridge deposits stop at
    # deposit_receipts_start_index — the eth1 queue drains only up to it.
    eth1_deposit_count = state.eth1_data.deposit_count
    if fork >= ForkName.ELECTRA:
        eth1_deposit_count = min(
            eth1_deposit_count, state.deposit_receipts_start_index
        )
    expected_deposits = min(
        E.MAX_DEPOSITS,
        max(0, eth1_deposit_count - state.eth1_deposit_index),
    )
    if len(body.deposits) != expected_deposits:
        raise BlockProcessingError(
            f"expected {expected_deposits} deposits, block has {len(body.deposits)}"
        )

    for ps in body.proposer_slashings:
        process_proposer_slashing(state, ps, spec, E, verify_signatures)
    for asl in body.attester_slashings:
        process_attester_slashing(state, asl, spec, E, verify_signatures)
    if fork >= ForkName.ALTAIR:
        from .attestation_batch import process_attestations

        process_attestations(
            state, body.attestations, spec, E, verify_signatures, ctxt, fork
        )
    else:
        for att in body.attestations:
            process_attestation(state, att, spec, E, verify_signatures, ctxt)
    for dep in body.deposits:
        process_deposit(state, dep, spec, E)
    for exit_ in body.voluntary_exits:
        process_voluntary_exit(state, exit_, spec, E, verify_signatures)
    if fork >= ForkName.CAPELLA:
        from .capella import process_bls_to_execution_change

        for change in body.bls_to_execution_changes:
            process_bls_to_execution_change(
                state, change, spec, E, verify_signatures
            )
    if fork >= ForkName.ELECTRA:
        from .bellatrix import is_execution_enabled
        from .electra import (
            process_deposit_receipt,
            process_execution_layer_withdrawal_request,
        )

        if is_execution_enabled(state, body):
            # spec operation order: deposit receipts, then withdrawal
            # requests — a same-block request may target a receipt's validator
            for receipt in body.execution_payload.deposit_receipts:
                process_deposit_receipt(state, receipt, spec, E)
            for req in body.execution_payload.withdrawal_requests:
                process_execution_layer_withdrawal_request(state, req, spec, E)


def process_proposer_slashing(state, ps, spec, E, verify_signatures: bool):
    h1 = ps.signed_header_1.message
    h2 = ps.signed_header_2.message
    if h1.slot != h2.slot:
        raise BlockProcessingError("proposer slashing: slot mismatch")
    if h1.proposer_index != h2.proposer_index:
        raise BlockProcessingError("proposer slashing: proposer mismatch")
    if h1 == h2:
        raise BlockProcessingError("proposer slashing: identical headers")
    if h1.proposer_index >= len(state.validators):
        raise BlockProcessingError("proposer slashing: unknown validator")
    proposer = state.validators[h1.proposer_index]
    if not is_slashable_validator(proposer, get_current_epoch(state, E)):
        raise BlockProcessingError("proposer slashing: not slashable")
    if verify_signatures:
        for sh in (ps.signed_header_1, ps.signed_header_2):
            if not sigsets.block_header_signature_set(state, sh, spec, E).verify():
                raise BlockProcessingError("proposer slashing: bad signature")
    slash_validator(state, h1.proposer_index, spec, E)


def process_attester_slashing(state, asl, spec, E, verify_signatures: bool):
    att1, att2 = asl.attestation_1, asl.attestation_2
    if not is_slashable_attestation_data(att1.data, att2.data):
        raise BlockProcessingError("attester slashing: not slashable data")
    for att in (att1, att2):
        if not is_valid_indexed_attestation(
            state, att, spec, E, verify_signature=verify_signatures
        ):
            raise BlockProcessingError("attester slashing: invalid attestation")
    slashed_any = False
    current = get_current_epoch(state, E)
    common = set(att1.attesting_indices) & set(att2.attesting_indices)
    for index in sorted(common):
        if is_slashable_validator(state.validators[index], current):
            slash_validator(state, index, spec, E)
            slashed_any = True
    if not slashed_any:
        raise BlockProcessingError("attester slashing: nobody slashed")


def process_attestation(
    state, attestation, spec, E, verify_signatures: bool, ctxt: ConsensusContext
):
    data = attestation.data
    current = get_current_epoch(state, E)
    previous = get_previous_epoch(state, E)
    if data.target.epoch not in (previous, current):
        raise BlockProcessingError("attestation: target epoch out of range")
    if data.target.epoch != compute_epoch_at_slot(data.slot, E):
        raise BlockProcessingError("attestation: target/slot mismatch")
    if not (
        data.slot + E.MIN_ATTESTATION_INCLUSION_DELAY
        <= state.slot
        <= data.slot + E.SLOTS_PER_EPOCH
    ):
        raise BlockProcessingError("attestation: inclusion window")
    cc = committee_cache_at(state, data.target.epoch, E)
    if data.index >= cc.committees_per_slot:
        raise BlockProcessingError("attestation: committee index out of range")
    committee = get_beacon_committee(state, data.slot, data.index, E)
    if len(attestation.aggregation_bits) != len(committee):
        raise BlockProcessingError("attestation: bitfield length mismatch")

    from ..types.containers import build_types

    t = build_types(E)
    pending = t.PendingAttestation(
        aggregation_bits=attestation.aggregation_bits,
        data=data,
        inclusion_delay=state.slot - data.slot,
        proposer_index=ctxt.get_proposer_index(state, E),
    )
    # validate EVERYTHING before the pending-attestation append: a
    # rejected attestation must leave no partial writes (the old order
    # appended first, so a bad indexed attestation left a phantom
    # PendingAttestation on the discarded state copy)
    if data.target.epoch == current:
        if data.source != state.current_justified_checkpoint:
            raise BlockProcessingError("attestation: wrong source (current)")
    elif data.source != state.previous_justified_checkpoint:
        raise BlockProcessingError("attestation: wrong source (previous)")

    indexed = ctxt.get_indexed_attestation(state, attestation, E)
    if not is_valid_indexed_attestation(
        state, indexed, spec, E, verify_signature=verify_signatures
    ):
        raise BlockProcessingError("attestation: invalid indexed attestation")

    if data.target.epoch == current:
        state.current_epoch_attestations.append(pending)
    else:
        state.previous_epoch_attestations.append(pending)


# ---------------------------------------------------------------------------
# Deposits
# ---------------------------------------------------------------------------


def is_valid_merkle_branch(
    leaf: bytes, branch, depth: int, index: int, root: bytes
) -> bool:
    value = leaf
    for i in range(depth):
        if (index >> i) & 1:
            value = hash32_concat(branch[i], value)
        else:
            value = hash32_concat(value, branch[i])
    return value == root


# Cross-state pubkey->index hints: the per-state dict below dies with
# every `state.copy()`, and block production/import always works on a
# fresh copy — at 1M validators the rebuild is seconds of Python per
# block. A pubkey's index never changes once assigned (the registry is
# append-only), so a hint from ANY state lineage is verified against THIS
# state with one element read and only a wrong/missing hint falls back to
# the full scan. Forks that assign the same pubkey different indices
# (duplicate deposits racing) fail the verification read and rescan —
# the hint layer is an accelerator, never an authority.
_PUBKEY_INDEX_HINTS: dict[bytes, int] = {}


def _validator_index_by_pubkey(state, pubkey: bytes) -> int | None:
    vs = state.validators
    hint = _PUBKEY_INDEX_HINTS.get(pubkey)
    if hint is not None and hint < len(vs) and vs[hint].pubkey == pubkey:
        return hint
    cache = getattr(state, "_lh_pubkey_index", None)
    if cache is not None:
        i = cache.get(pubkey)
        if i is not None and i < len(vs) and vs[i].pubkey == pubkey:
            return i
        if i is None and getattr(state, "_lh_pubkey_scan_len", -1) == len(vs):
            # the scan covered this exact registry: genuinely absent (the
            # new-deposit existence check must stay O(1), not rescan)
            return None
    cache = {v.pubkey: i for i, v in enumerate(vs)}
    object.__setattr__(state, "_lh_pubkey_index", cache)
    object.__setattr__(state, "_lh_pubkey_scan_len", len(vs))
    _PUBKEY_INDEX_HINTS.update(cache)
    return cache.get(pubkey)


def process_deposit(
    state,
    deposit,
    spec: ChainSpec,
    E,
    verify_proof: bool = True,
    signature_verified: bool = False,
):
    if verify_proof and not is_valid_merkle_branch(
        deposit.data.hash_tree_root(),
        deposit.proof,
        DEPOSIT_CONTRACT_TREE_DEPTH + 1,
        state.eth1_deposit_index,
        state.eth1_data.deposit_root,
    ):
        raise BlockProcessingError("deposit: invalid merkle proof")
    state.eth1_deposit_index += 1
    apply_deposit(state, deposit.data, spec, E, signature_verified)


def apply_deposit(state, data, spec: ChainSpec, E, signature_verified: bool = False):
    # Electra (EIP-7251): deposits flow through the pending-balance queue
    # (weight-denominated churn) instead of crediting balances directly.
    electra = hasattr(state, "pending_balance_deposits")
    index = _validator_index_by_pubkey(state, data.pubkey)
    if index is not None:
        if electra:
            from ..types.containers import build_types

            state.pending_balance_deposits.append(
                build_types(E).PendingBalanceDeposit(
                    index=index, amount=data.amount
                )
            )
        else:
            increase_balance(state, index, data.amount)
        return
    # New validator: the deposit signature is checked individually with the
    # deposit domain; an invalid signature skips the deposit (does not fail
    # the block). `signature_verified` lets genesis pre-verify all deposit
    # signatures in one batch (the reference's bulk-verification pattern).
    if not signature_verified and not bls.get_backend().fake:
        try:
            message = sigsets.deposit_signature_message(data, spec, E)
            pk = bls.PublicKey(data.pubkey)
            if not pk.validate():
                return
            if not bls.Signature(data.signature).verify(pk, message):
                return
        except (bls.BlsError, ValueError):
            return
    add_validator_to_registry(state, data, E)


def add_validator_to_registry(state, data, E):
    from ..types.containers import build_types

    t = build_types(E)
    amount = data.amount
    electra = hasattr(state, "pending_balance_deposits")
    if electra:
        # EIP-7251: new validators enter with zero balance; the deposited
        # amount rides the pending-balance queue.
        effective = 0
        balance = 0
    else:
        effective = min(
            amount - amount % E.EFFECTIVE_BALANCE_INCREMENT,
            E.MAX_EFFECTIVE_BALANCE,
        )
        balance = amount
    state.validators.append(
        t.Validator(
            pubkey=data.pubkey,
            withdrawal_credentials=data.withdrawal_credentials,
            effective_balance=effective,
            slashed=False,
            activation_eligibility_epoch=FAR_FUTURE_EPOCH,
            activation_epoch=FAR_FUTURE_EPOCH,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
        )
    )
    state.balances.append(balance)
    if electra:
        state.pending_balance_deposits.append(
            t.PendingBalanceDeposit(
                index=len(state.validators) - 1, amount=amount
            )
        )
    # Altair+ registries carry parallel per-validator lists.
    if hasattr(state, "previous_epoch_participation"):
        state.previous_epoch_participation.append(0)
        state.current_epoch_participation.append(0)
        state.inactivity_scores.append(0)
    cache = getattr(state, "_lh_pubkey_index", None)
    if cache is not None:
        cache[data.pubkey] = len(state.validators) - 1
        object.__setattr__(state, "_lh_pubkey_scan_len", len(state.validators))
        _PUBKEY_INDEX_HINTS[data.pubkey] = len(state.validators) - 1


def process_voluntary_exit(state, signed_exit, spec, E, verify_signatures: bool):
    exit_msg = signed_exit.message
    if exit_msg.validator_index >= len(state.validators):
        raise BlockProcessingError("exit: unknown validator")
    v = state.validators[exit_msg.validator_index]
    current = get_current_epoch(state, E)
    from .accessors import is_active_validator

    if not is_active_validator(v, current):
        raise BlockProcessingError("exit: validator not active")
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        raise BlockProcessingError("exit: already exiting")
    if current < exit_msg.epoch:
        raise BlockProcessingError("exit: not yet valid")
    if current < v.activation_epoch + spec.shard_committee_period:
        raise BlockProcessingError("exit: too young")
    if verify_signatures and not sigsets.exit_signature_set(
        state, signed_exit, spec, E
    ).verify():
        raise BlockProcessingError("exit: bad signature")
    if hasattr(state, "pending_partial_withdrawals"):
        # Electra: only exit when no pending partial withdrawals remain
        from .electra import get_pending_balance_to_withdraw

        if get_pending_balance_to_withdraw(state, exit_msg.validator_index) != 0:
            raise BlockProcessingError("exit: pending partial withdrawals")
    initiate_validator_exit(state, exit_msg.validator_index, spec, E)
