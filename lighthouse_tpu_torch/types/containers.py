"""Consensus SSZ containers for every fork, parameterized by preset.

The reference uses `superstruct` multi-variant structs generic over the
`EthSpec` trait (consensus/types/src/beacon_state.rs:208-326,
beacon_block.rs). Here each preset gets its own concrete class family, built
once by `build_types(preset)` and cached; per-fork variants live in a
`ForkTypes` namespace registry (`types.forks[ForkName.ALTAIR].BeaconState`).

NOTE: no `from __future__ import annotations` here — the SSZ Container
metaclass consumes real type objects from __annotations__, and these classes
are built inside a function scope.
"""

import functools
from types import SimpleNamespace

from ..ssz.persistent import (
    PersistentByteList,
    PersistentContainerList,
    PersistentList,
)
from ..ssz.core import (
    Bitlist,
    Bitvector,
    ByteList,
    ParticipationList,
    ByteVector,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    List,
    Vector,
    boolean,
    uint8,
    uint64,
    uint256,
)
from .chain_spec import ForkName
from .eth_spec import EthSpec

KZGCommitment = Bytes48
KZGProof = Bytes48
BLSPubkey = Bytes48
BLSSignature = Bytes96
ExecutionAddress = Bytes20


def _state_hash_tree_root(self) -> bytes:
    """Shared BeaconState hash_tree_root hook: registry-scale fields ride
    the incremental caches (cached_tree_hash analog;
    beacon_state.rs:2002-2004). Assigned on BOTH state families — phase0
    and Altair+ are separate class hierarchies."""
    from ..ssz.cached_tree_hash import cached_state_root

    return cached_state_root(self)


@functools.cache
def build_types(E: type) -> SimpleNamespace:
    """Build the full container family for preset `E` (an EthSpec subclass)."""
    assert issubclass(E, EthSpec)

    # -- Phase 0 containers (consensus-specs phase0/beacon-chain.md) -------

    class Fork(Container):
        previous_version: Bytes4
        current_version: Bytes4
        epoch: uint64

    class ForkData(Container):
        current_version: Bytes4
        genesis_validators_root: Bytes32

    class Checkpoint(Container):
        epoch: uint64
        root: Bytes32

    class Validator(Container):
        pubkey: BLSPubkey
        withdrawal_credentials: Bytes32
        effective_balance: uint64
        slashed: boolean
        activation_eligibility_epoch: uint64
        activation_epoch: uint64
        exit_epoch: uint64
        withdrawable_epoch: uint64

    class AttestationData(Container):
        slot: uint64
        index: uint64
        beacon_block_root: Bytes32
        source: Checkpoint
        target: Checkpoint

    class IndexedAttestation(Container):
        attesting_indices: List[uint64, E.MAX_VALIDATORS_PER_COMMITTEE]
        data: AttestationData
        signature: BLSSignature

    class PendingAttestation(Container):
        aggregation_bits: Bitlist[E.MAX_VALIDATORS_PER_COMMITTEE]
        data: AttestationData
        inclusion_delay: uint64
        proposer_index: uint64

    class Eth1Data(Container):
        deposit_root: Bytes32
        deposit_count: uint64
        block_hash: Bytes32

    class HistoricalBatch(Container):
        block_roots: Vector[Bytes32, E.SLOTS_PER_HISTORICAL_ROOT]
        state_roots: Vector[Bytes32, E.SLOTS_PER_HISTORICAL_ROOT]

    class DepositMessage(Container):
        pubkey: BLSPubkey
        withdrawal_credentials: Bytes32
        amount: uint64

    class DepositData(Container):
        pubkey: BLSPubkey
        withdrawal_credentials: Bytes32
        amount: uint64
        signature: BLSSignature

    class BeaconBlockHeader(Container):
        slot: uint64
        proposer_index: uint64
        parent_root: Bytes32
        state_root: Bytes32
        body_root: Bytes32

    class SignedBeaconBlockHeader(Container):
        message: BeaconBlockHeader
        signature: BLSSignature

    class SigningData(Container):
        object_root: Bytes32
        domain: Bytes32

    class ProposerSlashing(Container):
        signed_header_1: SignedBeaconBlockHeader
        signed_header_2: SignedBeaconBlockHeader

    class AttesterSlashing(Container):
        attestation_1: IndexedAttestation
        attestation_2: IndexedAttestation

    class Attestation(Container):
        aggregation_bits: Bitlist[E.MAX_VALIDATORS_PER_COMMITTEE]
        data: AttestationData
        signature: BLSSignature

    class Deposit(Container):
        proof: Vector[Bytes32, 33]  # DEPOSIT_CONTRACT_TREE_DEPTH + 1
        data: DepositData

    class VoluntaryExit(Container):
        epoch: uint64
        validator_index: uint64

    class SignedVoluntaryExit(Container):
        message: VoluntaryExit
        signature: BLSSignature

    class BeaconBlockBody(Container):
        randao_reveal: BLSSignature
        eth1_data: Eth1Data
        graffiti: Bytes32
        proposer_slashings: List[ProposerSlashing, E.MAX_PROPOSER_SLASHINGS]
        attester_slashings: List[AttesterSlashing, E.MAX_ATTESTER_SLASHINGS]
        attestations: List[Attestation, E.MAX_ATTESTATIONS]
        deposits: List[Deposit, E.MAX_DEPOSITS]
        voluntary_exits: List[SignedVoluntaryExit, E.MAX_VOLUNTARY_EXITS]

    class BeaconBlock(Container):
        slot: uint64
        proposer_index: uint64
        parent_root: Bytes32
        state_root: Bytes32
        body: BeaconBlockBody

    class SignedBeaconBlock(Container):
        message: BeaconBlock
        signature: BLSSignature

    class BeaconState(Container):
        genesis_time: uint64
        genesis_validators_root: Bytes32
        slot: uint64
        fork: Fork
        latest_block_header: BeaconBlockHeader
        block_roots: Vector[Bytes32, E.SLOTS_PER_HISTORICAL_ROOT]
        state_roots: Vector[Bytes32, E.SLOTS_PER_HISTORICAL_ROOT]
        historical_roots: List[Bytes32, E.HISTORICAL_ROOTS_LIMIT]
        eth1_data: Eth1Data
        eth1_data_votes: List[Eth1Data, E.slots_per_eth1_voting_period()]
        eth1_deposit_index: uint64
        validators: List[Validator, E.VALIDATOR_REGISTRY_LIMIT]
        balances: List[uint64, E.VALIDATOR_REGISTRY_LIMIT]
        randao_mixes: Vector[Bytes32, E.EPOCHS_PER_HISTORICAL_VECTOR]
        slashings: Vector[uint64, E.EPOCHS_PER_SLASHINGS_VECTOR]
        previous_epoch_attestations: List[PendingAttestation, E.pending_attestations_limit()]
        current_epoch_attestations: List[PendingAttestation, E.pending_attestations_limit()]
        justification_bits: Bitvector[4]
        previous_justified_checkpoint: Checkpoint
        current_justified_checkpoint: Checkpoint
        finalized_checkpoint: Checkpoint

        # incremental per-field caches for the registry-scale fields
        # (cached_tree_hash analog; beacon_state.rs:2002-2004). The
        # declaration of WHICH fields are registry-scale lives here with
        # the layout, not in the cache (phase0 has no participation or
        # inactivity fields — subclass families inherit and extend).
        hash_tree_root = _state_hash_tree_root
        _THC_LIST_FIELDS = ("validators", "balances")
        # registry-scale fields mirrored by the resident column store
        # (state_processing/registry_columns): columns engage only when
        # every listed field is in the persistent (tree-states)
        # representation — plain-list states take the legacy epoch path
        _REGISTRY_COLUMN_FIELDS = (
            ("validators", PersistentContainerList),
            ("balances", PersistentList),
        )

    class AggregateAndProof(Container):
        aggregator_index: uint64
        aggregate: Attestation
        selection_proof: BLSSignature

    class SignedAggregateAndProof(Container):
        message: AggregateAndProof
        signature: BLSSignature

    # -- Altair ------------------------------------------------------------

    class SyncAggregate(Container):
        sync_committee_bits: Bitvector[E.SYNC_COMMITTEE_SIZE]
        sync_committee_signature: BLSSignature

    class SyncCommittee(Container):
        pubkeys: Vector[BLSPubkey, E.SYNC_COMMITTEE_SIZE]
        aggregate_pubkey: BLSPubkey

    class SyncCommitteeMessage(Container):
        slot: uint64
        beacon_block_root: Bytes32
        validator_index: uint64
        signature: BLSSignature

    class SyncCommitteeContribution(Container):
        slot: uint64
        beacon_block_root: Bytes32
        subcommittee_index: uint64
        aggregation_bits: Bitvector[E.SYNC_COMMITTEE_SIZE // 4]
        signature: BLSSignature

    class ContributionAndProof(Container):
        aggregator_index: uint64
        contribution: SyncCommitteeContribution
        selection_proof: BLSSignature

    class SignedContributionAndProof(Container):
        message: ContributionAndProof
        signature: BLSSignature

    class SyncAggregatorSelectionData(Container):
        slot: uint64
        subcommittee_index: uint64

# Fork variants below inherit: the Container metaclass merges annotations in
    # MRO order, appending new fields and overriding re-annotated ones in place
    # — the superstruct "append-only variant" pattern without field copy-paste.

    class BeaconBlockBodyAltair(BeaconBlockBody):
        sync_aggregate: SyncAggregate

    class BeaconBlockAltair(BeaconBlock):
        body: BeaconBlockBodyAltair

    class SignedBeaconBlockAltair(SignedBeaconBlock):
        message: BeaconBlockAltair

    class BeaconStateAltair(Container):
        genesis_time: uint64
        genesis_validators_root: Bytes32
        slot: uint64
        fork: Fork
        latest_block_header: BeaconBlockHeader
        block_roots: Vector[Bytes32, E.SLOTS_PER_HISTORICAL_ROOT]
        state_roots: Vector[Bytes32, E.SLOTS_PER_HISTORICAL_ROOT]
        historical_roots: List[Bytes32, E.HISTORICAL_ROOTS_LIMIT]
        eth1_data: Eth1Data
        eth1_data_votes: List[Eth1Data, E.slots_per_eth1_voting_period()]
        eth1_deposit_index: uint64
        validators: List[Validator, E.VALIDATOR_REGISTRY_LIMIT]
        balances: List[uint64, E.VALIDATOR_REGISTRY_LIMIT]
        randao_mixes: Vector[Bytes32, E.EPOCHS_PER_HISTORICAL_VECTOR]
        slashings: Vector[uint64, E.EPOCHS_PER_SLASHINGS_VECTOR]
        previous_epoch_participation: ParticipationList[E.VALIDATOR_REGISTRY_LIMIT]
        current_epoch_participation: ParticipationList[E.VALIDATOR_REGISTRY_LIMIT]
        justification_bits: Bitvector[4]
        previous_justified_checkpoint: Checkpoint
        current_justified_checkpoint: Checkpoint
        finalized_checkpoint: Checkpoint
        inactivity_scores: List[uint64, E.VALIDATOR_REGISTRY_LIMIT]
        current_sync_committee: SyncCommittee
        next_sync_committee: SyncCommittee

        # Altair+ states are NOT subclasses of the phase0 BeaconState
        # (different field layout), so they need their own hook — and
        # their own registry-scale field declaration (participation and
        # inactivity lists join the cached set; Bellatrix+ inherit)
        hash_tree_root = _state_hash_tree_root
        _THC_LIST_FIELDS = (
            "validators",
            "balances",
            "previous_epoch_participation",
            "current_epoch_participation",
            "inactivity_scores",
        )
        _REGISTRY_COLUMN_FIELDS = (
            ("validators", PersistentContainerList),
            ("balances", PersistentList),
            ("inactivity_scores", PersistentList),
            # the attestation pipeline's scatter target: participation is
            # resident too (columns engage only when every field is
            # persistent — chain._make_persistent converts all of them)
            ("previous_epoch_participation", PersistentByteList),
            ("current_epoch_participation", PersistentByteList),
        )

    # -- Bellatrix (execution payloads) ------------------------------------

    Transaction = ByteList[E.MAX_BYTES_PER_TRANSACTION]

    class ExecutionPayload(Container):
        parent_hash: Bytes32
        fee_recipient: ExecutionAddress
        state_root: Bytes32
        receipts_root: Bytes32
        logs_bloom: ByteVector[E.BYTES_PER_LOGS_BLOOM]
        prev_randao: Bytes32
        block_number: uint64
        gas_limit: uint64
        gas_used: uint64
        timestamp: uint64
        extra_data: ByteList[E.MAX_EXTRA_DATA_BYTES]
        base_fee_per_gas: uint256
        block_hash: Bytes32
        transactions: List[Transaction, E.MAX_TRANSACTIONS_PER_PAYLOAD]

    class ExecutionPayloadHeader(Container):
        parent_hash: Bytes32
        fee_recipient: ExecutionAddress
        state_root: Bytes32
        receipts_root: Bytes32
        logs_bloom: ByteVector[E.BYTES_PER_LOGS_BLOOM]
        prev_randao: Bytes32
        block_number: uint64
        gas_limit: uint64
        gas_used: uint64
        timestamp: uint64
        extra_data: ByteList[E.MAX_EXTRA_DATA_BYTES]
        base_fee_per_gas: uint256
        block_hash: Bytes32
        transactions_root: Bytes32

    class PowBlock(Container):
        block_hash: Bytes32
        parent_hash: Bytes32
        total_difficulty: uint256

    class BeaconBlockBodyBellatrix(BeaconBlockBodyAltair):
        execution_payload: ExecutionPayload

    class BeaconBlockBellatrix(BeaconBlock):
        body: BeaconBlockBodyBellatrix

    class SignedBeaconBlockBellatrix(SignedBeaconBlock):
        message: BeaconBlockBellatrix

    class BeaconStateBellatrix(BeaconStateAltair):
        latest_execution_payload_header: ExecutionPayloadHeader

    # -- Capella -----------------------------------------------------------

    class Withdrawal(Container):
        index: uint64
        validator_index: uint64
        address: ExecutionAddress
        amount: uint64

    class BLSToExecutionChange(Container):
        validator_index: uint64
        from_bls_pubkey: BLSPubkey
        to_execution_address: ExecutionAddress

    class SignedBLSToExecutionChange(Container):
        message: BLSToExecutionChange
        signature: BLSSignature

    class HistoricalSummary(Container):
        block_summary_root: Bytes32
        state_summary_root: Bytes32

    class ExecutionPayloadCapella(ExecutionPayload):
        withdrawals: List[Withdrawal, E.MAX_WITHDRAWALS_PER_PAYLOAD]

    class ExecutionPayloadHeaderCapella(ExecutionPayloadHeader):
        withdrawals_root: Bytes32

    class BeaconBlockBodyCapella(BeaconBlockBodyBellatrix):
        execution_payload: ExecutionPayloadCapella
        bls_to_execution_changes: List[
            SignedBLSToExecutionChange, E.MAX_BLS_TO_EXECUTION_CHANGES
        ]

    class BeaconBlockCapella(BeaconBlock):
        body: BeaconBlockBodyCapella

    class SignedBeaconBlockCapella(SignedBeaconBlock):
        message: BeaconBlockCapella

    class BeaconStateCapella(BeaconStateBellatrix):
        latest_execution_payload_header: ExecutionPayloadHeaderCapella
        next_withdrawal_index: uint64
        next_withdrawal_validator_index: uint64
        historical_summaries: List[HistoricalSummary, E.HISTORICAL_ROOTS_LIMIT]

    # -- Deneb (blobs) -----------------------------------------------------

    Blob = ByteVector[E.bytes_per_blob()]

    class ExecutionPayloadDeneb(ExecutionPayloadCapella):
        blob_gas_used: uint64
        excess_blob_gas: uint64

    class ExecutionPayloadHeaderDeneb(ExecutionPayloadHeaderCapella):
        blob_gas_used: uint64
        excess_blob_gas: uint64

    class BeaconBlockBodyDeneb(BeaconBlockBodyCapella):
        execution_payload: ExecutionPayloadDeneb
        blob_kzg_commitments: List[KZGCommitment, E.MAX_BLOB_COMMITMENTS_PER_BLOCK]

    class BeaconBlockDeneb(BeaconBlock):
        body: BeaconBlockBodyDeneb

    class SignedBeaconBlockDeneb(SignedBeaconBlock):
        message: BeaconBlockDeneb

    class BeaconStateDeneb(BeaconStateCapella):
        latest_execution_payload_header: ExecutionPayloadHeaderDeneb

    class BlobIdentifier(Container):
        block_root: Bytes32
        index: uint64

    class BlobSidecar(Container):
        index: uint64
        blob: Blob
        kzg_commitment: KZGCommitment
        kzg_proof: KZGProof
        signed_block_header: SignedBeaconBlockHeader
        kzg_commitment_inclusion_proof: Vector[
            Bytes32, E.KZG_COMMITMENT_INCLUSION_PROOF_DEPTH
        ]

    # -- PeerDAS data columns (EIP-7594) -----------------------------------

    Cell = ByteVector[E.bytes_per_cell()]

    class DataColumnIdentifier(Container):
        block_root: Bytes32
        index: uint64

    class DataColumnSidecar(Container):
        """One column of the erasure-coded blob matrix: cell `index` of
        EVERY blob in the block, with one KZG proof per cell and the
        whole commitments list proven against the block body root."""

        index: uint64
        column: List[Cell, E.MAX_BLOB_COMMITMENTS_PER_BLOCK]
        kzg_commitments: List[KZGCommitment, E.MAX_BLOB_COMMITMENTS_PER_BLOCK]
        kzg_proofs: List[KZGProof, E.MAX_BLOB_COMMITMENTS_PER_BLOCK]
        signed_block_header: SignedBeaconBlockHeader
        kzg_commitments_inclusion_proof: Vector[
            Bytes32, E.KZG_COMMITMENTS_INCLUSION_PROOF_DEPTH
        ]

    # -- Electra (EIP-7251 maxeb / EIP-7002 EL withdrawals / EIP-6110
    #    deposit receipts; reference consensus/types/src/{deposit_receipt,
    #    execution_layer_withdrawal_request,pending_*}.rs)
    #
    #    NOTE: these Electra shapes follow the ~2024-10 devnet spec the
    #    reference snapshot tracks (e.g. `DepositReceipt`, per-payload
    #    `withdrawal_requests`), NOT the finalized mainnet Electra layout
    #    (which moved EL requests out of the payload into
    #    `ExecutionRequests`). Callers building against mainnet Electra
    #    must update these containers first. --------------------------------

    class DepositReceipt(Container):
        pubkey: BLSPubkey
        withdrawal_credentials: Bytes32
        amount: uint64
        signature: BLSSignature
        index: uint64

    class ExecutionLayerWithdrawalRequest(Container):
        source_address: ExecutionAddress
        validator_pubkey: BLSPubkey
        amount: uint64

    class PendingBalanceDeposit(Container):
        index: uint64
        amount: uint64

    class PendingPartialWithdrawal(Container):
        index: uint64
        amount: uint64
        withdrawable_epoch: uint64

    class PendingConsolidation(Container):
        source_index: uint64
        target_index: uint64

    class Consolidation(Container):
        source_index: uint64
        target_index: uint64
        epoch: uint64

    class SignedConsolidation(Container):
        message: Consolidation
        signature: BLSSignature

    class ExecutionPayloadElectra(ExecutionPayloadDeneb):
        deposit_receipts: List[DepositReceipt, E.MAX_DEPOSIT_RECEIPTS_PER_PAYLOAD]
        withdrawal_requests: List[
            ExecutionLayerWithdrawalRequest, E.MAX_WITHDRAWAL_REQUESTS_PER_PAYLOAD
        ]

    class ExecutionPayloadHeaderElectra(ExecutionPayloadHeaderDeneb):
        deposit_receipts_root: Bytes32
        withdrawal_requests_root: Bytes32

    class BeaconBlockBodyElectra(BeaconBlockBodyDeneb):
        execution_payload: ExecutionPayloadElectra

    class BeaconBlockElectra(BeaconBlock):
        body: BeaconBlockBodyElectra

    class SignedBeaconBlockElectra(SignedBeaconBlock):
        message: BeaconBlockElectra

    class BeaconStateElectra(BeaconStateDeneb):
        latest_execution_payload_header: ExecutionPayloadHeaderElectra
        deposit_receipts_start_index: uint64
        deposit_balance_to_consume: uint64
        exit_balance_to_consume: uint64
        earliest_exit_epoch: uint64
        consolidation_balance_to_consume: uint64
        earliest_consolidation_epoch: uint64
        pending_balance_deposits: List[
            PendingBalanceDeposit, E.PENDING_BALANCE_DEPOSITS_LIMIT
        ]
        pending_partial_withdrawals: List[
            PendingPartialWithdrawal, E.PENDING_PARTIAL_WITHDRAWALS_LIMIT
        ]
        pending_consolidations: List[
            PendingConsolidation, E.PENDING_CONSOLIDATIONS_LIMIT
        ]

    # -- Fork registry (the superstruct analog) ----------------------------

    forks = {
        ForkName.PHASE0: SimpleNamespace(
            BeaconState=BeaconState,
            BeaconBlock=BeaconBlock,
            BeaconBlockBody=BeaconBlockBody,
            SignedBeaconBlock=SignedBeaconBlock,
            ExecutionPayload=None,
            ExecutionPayloadHeader=None,
        ),
        ForkName.ALTAIR: SimpleNamespace(
            BeaconState=BeaconStateAltair,
            BeaconBlock=BeaconBlockAltair,
            BeaconBlockBody=BeaconBlockBodyAltair,
            SignedBeaconBlock=SignedBeaconBlockAltair,
            ExecutionPayload=None,
            ExecutionPayloadHeader=None,
        ),
        ForkName.BELLATRIX: SimpleNamespace(
            BeaconState=BeaconStateBellatrix,
            BeaconBlock=BeaconBlockBellatrix,
            BeaconBlockBody=BeaconBlockBodyBellatrix,
            SignedBeaconBlock=SignedBeaconBlockBellatrix,
            ExecutionPayload=ExecutionPayload,
            ExecutionPayloadHeader=ExecutionPayloadHeader,
        ),
        ForkName.CAPELLA: SimpleNamespace(
            BeaconState=BeaconStateCapella,
            BeaconBlock=BeaconBlockCapella,
            BeaconBlockBody=BeaconBlockBodyCapella,
            SignedBeaconBlock=SignedBeaconBlockCapella,
            ExecutionPayload=ExecutionPayloadCapella,
            ExecutionPayloadHeader=ExecutionPayloadHeaderCapella,
        ),
        ForkName.DENEB: SimpleNamespace(
            BeaconState=BeaconStateDeneb,
            BeaconBlock=BeaconBlockDeneb,
            BeaconBlockBody=BeaconBlockBodyDeneb,
            SignedBeaconBlock=SignedBeaconBlockDeneb,
            ExecutionPayload=ExecutionPayloadDeneb,
            ExecutionPayloadHeader=ExecutionPayloadHeaderDeneb,
        ),
        ForkName.ELECTRA: SimpleNamespace(
            BeaconState=BeaconStateElectra,
            BeaconBlock=BeaconBlockElectra,
            BeaconBlockBody=BeaconBlockBodyElectra,
            SignedBeaconBlock=SignedBeaconBlockElectra,
            ExecutionPayload=ExecutionPayloadElectra,
            ExecutionPayloadHeader=ExecutionPayloadHeaderElectra,
        ),
    }

    _state_to_fork = {v.BeaconState: k for k, v in forks.items()}
    _block_to_fork = {v.BeaconBlock: k for k, v in forks.items()}

    def fork_of_state(state) -> ForkName:
        return _state_to_fork[type(state)]

    def fork_of_block(block) -> ForkName:
        return _block_to_fork[type(block)]

    def types_for_fork(fork: ForkName) -> SimpleNamespace:
        ns = forks.get(ForkName(fork))
        if ns is None:
            raise NotImplementedError(
                f"containers for fork {fork} are not implemented yet"
            )
        return ns

    def decode_by_fork(kind: str, data: bytes):
        """Resolve an SSZ blob's fork variant by decoding newest-first and
        accepting on exact re-serialization (sibling fork layouts can both
        decode loosely; the byte-exact roundtrip disambiguates). `kind` is
        the per-fork attribute name, e.g. "SignedBeaconBlock"/"BeaconState".
        Raises ValueError when no fork matches."""
        for fork in reversed(list(forks)):
            cls = getattr(forks[fork], kind, None)
            if cls is None:
                continue
            try:
                obj = cls.deserialize(data)
            except Exception:  # noqa: BLE001 — not this fork's layout
                continue
            if cls.serialize_value(obj) == data:
                return obj
        raise ValueError(f"data does not decode as {kind} under any fork")

    return SimpleNamespace(
        preset=E,
        forks=forks,
        fork_of_state=fork_of_state,
        fork_of_block=fork_of_block,
        types_for_fork=types_for_fork,
        decode_by_fork=decode_by_fork,
        # phase0 family (flat access for the common case)
        Fork=Fork,
        ForkData=ForkData,
        Checkpoint=Checkpoint,
        Validator=Validator,
        AttestationData=AttestationData,
        IndexedAttestation=IndexedAttestation,
        PendingAttestation=PendingAttestation,
        Eth1Data=Eth1Data,
        HistoricalBatch=HistoricalBatch,
        DepositMessage=DepositMessage,
        DepositData=DepositData,
        BeaconBlockHeader=BeaconBlockHeader,
        SignedBeaconBlockHeader=SignedBeaconBlockHeader,
        SigningData=SigningData,
        ProposerSlashing=ProposerSlashing,
        AttesterSlashing=AttesterSlashing,
        Attestation=Attestation,
        Deposit=Deposit,
        VoluntaryExit=VoluntaryExit,
        SignedVoluntaryExit=SignedVoluntaryExit,
        BeaconBlockBody=BeaconBlockBody,
        BeaconBlock=BeaconBlock,
        SignedBeaconBlock=SignedBeaconBlock,
        BeaconState=BeaconState,
        AggregateAndProof=AggregateAndProof,
        SignedAggregateAndProof=SignedAggregateAndProof,
        # altair
        SyncAggregate=SyncAggregate,
        SyncCommittee=SyncCommittee,
        SyncCommitteeMessage=SyncCommitteeMessage,
        SyncCommitteeContribution=SyncCommitteeContribution,
        ContributionAndProof=ContributionAndProof,
        SignedContributionAndProof=SignedContributionAndProof,
        SyncAggregatorSelectionData=SyncAggregatorSelectionData,
        BeaconStateAltair=BeaconStateAltair,
        BeaconBlockAltair=BeaconBlockAltair,
        BeaconBlockBodyAltair=BeaconBlockBodyAltair,
        SignedBeaconBlockAltair=SignedBeaconBlockAltair,
        # bellatrix
        Transaction=Transaction,
        ExecutionPayload=ExecutionPayload,
        ExecutionPayloadHeader=ExecutionPayloadHeader,
        PowBlock=PowBlock,
        BeaconStateBellatrix=BeaconStateBellatrix,
        BeaconBlockBellatrix=BeaconBlockBellatrix,
        BeaconBlockBodyBellatrix=BeaconBlockBodyBellatrix,
        SignedBeaconBlockBellatrix=SignedBeaconBlockBellatrix,
        # capella
        Withdrawal=Withdrawal,
        BLSToExecutionChange=BLSToExecutionChange,
        SignedBLSToExecutionChange=SignedBLSToExecutionChange,
        HistoricalSummary=HistoricalSummary,
        ExecutionPayloadCapella=ExecutionPayloadCapella,
        ExecutionPayloadHeaderCapella=ExecutionPayloadHeaderCapella,
        BeaconStateCapella=BeaconStateCapella,
        BeaconBlockCapella=BeaconBlockCapella,
        BeaconBlockBodyCapella=BeaconBlockBodyCapella,
        SignedBeaconBlockCapella=SignedBeaconBlockCapella,
        # deneb
        Blob=Blob,
        ExecutionPayloadDeneb=ExecutionPayloadDeneb,
        ExecutionPayloadHeaderDeneb=ExecutionPayloadHeaderDeneb,
        BeaconStateDeneb=BeaconStateDeneb,
        BeaconBlockDeneb=BeaconBlockDeneb,
        BeaconBlockBodyDeneb=BeaconBlockBodyDeneb,
        SignedBeaconBlockDeneb=SignedBeaconBlockDeneb,
        BlobIdentifier=BlobIdentifier,
        BlobSidecar=BlobSidecar,
        # peerdas
        Cell=Cell,
        DataColumnIdentifier=DataColumnIdentifier,
        DataColumnSidecar=DataColumnSidecar,
        # electra
        DepositReceipt=DepositReceipt,
        ExecutionLayerWithdrawalRequest=ExecutionLayerWithdrawalRequest,
        PendingBalanceDeposit=PendingBalanceDeposit,
        PendingPartialWithdrawal=PendingPartialWithdrawal,
        PendingConsolidation=PendingConsolidation,
        Consolidation=Consolidation,
        SignedConsolidation=SignedConsolidation,
        ExecutionPayloadElectra=ExecutionPayloadElectra,
        ExecutionPayloadHeaderElectra=ExecutionPayloadHeaderElectra,
        BeaconStateElectra=BeaconStateElectra,
        BeaconBlockElectra=BeaconBlockElectra,
        BeaconBlockBodyElectra=BeaconBlockBodyElectra,
        SignedBeaconBlockElectra=SignedBeaconBlockElectra,
    )
