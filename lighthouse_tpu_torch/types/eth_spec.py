"""Compile-time spec presets (the reference's `EthSpec` trait).

Mirrors consensus/types/src/eth_spec.rs:53 (`EthSpec` trait with type-level
constants; `MainnetEthSpec` :362, `MinimalEthSpec` :420). Each preset is a
class whose attributes are the SSZ-type-shaping constants; runtime
configuration (fork schedule, genesis, timing) lives in ChainSpec
(chain_spec.py), matching the reference's preset/config split.
"""

from __future__ import annotations


class EthSpec:
    """Mainnet preset. Subclasses override for minimal/gnosis."""

    NAME = "mainnet"

    # --- Misc -------------------------------------------------------------
    MAX_COMMITTEES_PER_SLOT = 64
    TARGET_COMMITTEE_SIZE = 128
    MAX_VALIDATORS_PER_COMMITTEE = 2048
    SHUFFLE_ROUND_COUNT = 90
    HYSTERESIS_QUOTIENT = 4
    HYSTERESIS_DOWNWARD_MULTIPLIER = 1
    HYSTERESIS_UPWARD_MULTIPLIER = 5

    # --- Gwei values ------------------------------------------------------
    MIN_DEPOSIT_AMOUNT = 2**0 * 10**9
    MAX_EFFECTIVE_BALANCE = 2**5 * 10**9
    EFFECTIVE_BALANCE_INCREMENT = 2**0 * 10**9

    # --- Time parameters (in slots/epochs; wall-clock lives in ChainSpec) -
    MIN_ATTESTATION_INCLUSION_DELAY = 1
    SLOTS_PER_EPOCH = 32
    MIN_SEED_LOOKAHEAD = 1
    MAX_SEED_LOOKAHEAD = 4
    EPOCHS_PER_ETH1_VOTING_PERIOD = 64
    SLOTS_PER_HISTORICAL_ROOT = 8192
    MIN_EPOCHS_TO_INACTIVITY_PENALTY = 4

    # --- State list lengths ----------------------------------------------
    EPOCHS_PER_HISTORICAL_VECTOR = 65536
    EPOCHS_PER_SLASHINGS_VECTOR = 8192
    HISTORICAL_ROOTS_LIMIT = 2**24
    VALIDATOR_REGISTRY_LIMIT = 2**40

    # --- Rewards and penalties (phase0) ----------------------------------
    BASE_REWARD_FACTOR = 64
    WHISTLEBLOWER_REWARD_QUOTIENT = 512
    PROPOSER_REWARD_QUOTIENT = 8
    INACTIVITY_PENALTY_QUOTIENT = 2**26
    MIN_SLASHING_PENALTY_QUOTIENT = 128
    PROPORTIONAL_SLASHING_MULTIPLIER = 1

    # --- Max operations per block ----------------------------------------
    MAX_PROPOSER_SLASHINGS = 16
    MAX_ATTESTER_SLASHINGS = 2
    MAX_ATTESTATIONS = 128
    MAX_DEPOSITS = 16
    MAX_VOLUNTARY_EXITS = 16

    # --- Altair -----------------------------------------------------------
    SYNC_COMMITTEE_SIZE = 512
    EPOCHS_PER_SYNC_COMMITTEE_PERIOD = 256
    INACTIVITY_PENALTY_QUOTIENT_ALTAIR = 3 * 2**24
    MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR = 64
    PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR = 2
    MIN_SYNC_COMMITTEE_PARTICIPANTS = 1

    # --- Bellatrix (execution payloads) ----------------------------------
    INACTIVITY_PENALTY_QUOTIENT_BELLATRIX = 2**24
    MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX = 32
    PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX = 3
    MAX_BYTES_PER_TRANSACTION = 2**30
    MAX_TRANSACTIONS_PER_PAYLOAD = 2**20
    BYTES_PER_LOGS_BLOOM = 256
    MAX_EXTRA_DATA_BYTES = 32

    # --- Capella ----------------------------------------------------------
    MAX_WITHDRAWALS_PER_PAYLOAD = 16
    MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP = 16384
    MAX_BLS_TO_EXECUTION_CHANGES = 16

    # --- Deneb ------------------------------------------------------------
    FIELD_ELEMENTS_PER_BLOB = 4096
    MAX_BLOB_COMMITMENTS_PER_BLOCK = 4096
    MAX_BLOBS_PER_BLOCK = 6
    KZG_COMMITMENT_INCLUSION_PROOF_DEPTH = 17

    # --- PeerDAS (EIP-7594 data-availability sampling) --------------------
    # The extended (2x erasure-coded) blob is sliced into this many cells;
    # one DataColumnSidecar carries cell j of every blob in a block.
    NUMBER_OF_COLUMNS = 128
    # gossip fan-out: column j rides subnet j % SUBNET_COUNT
    DATA_COLUMN_SIDECAR_SUBNET_COUNT = 64
    #: columns a node must custody (and serve) as a function of node id
    CUSTODY_REQUIREMENT = 4
    #: random non-custody columns a node samples per slot
    SAMPLES_PER_SLOT = 8
    #: depth of the whole-`blob_kzg_commitments`-list proof against the
    #: block body root (the body has <=16 fields in every preset, so the
    #: field branch is 4 deep — contrast the per-commitment blob proof,
    #: which adds the list element + length-mixin levels)
    KZG_COMMITMENTS_INCLUSION_PROOF_DEPTH = 4

    # --- Electra (EIP-7251/7002/6110; eth_spec.rs Electra associated
    # types in the reference) ----------------------------------------------
    PENDING_BALANCE_DEPOSITS_LIMIT = 2**27
    PENDING_PARTIAL_WITHDRAWALS_LIMIT = 2**27
    PENDING_CONSOLIDATIONS_LIMIT = 2**18
    MAX_DEPOSIT_RECEIPTS_PER_PAYLOAD = 8192
    MAX_WITHDRAWAL_REQUESTS_PER_PAYLOAD = 16
    MAX_PENDING_PARTIALS_PER_WITHDRAWALS_SWEEP = 8

    # --- Derived helpers --------------------------------------------------

    @classmethod
    def slots_per_eth1_voting_period(cls) -> int:
        return cls.EPOCHS_PER_ETH1_VOTING_PERIOD * cls.SLOTS_PER_EPOCH

    @classmethod
    def pending_attestations_limit(cls) -> int:
        return cls.MAX_ATTESTATIONS * cls.SLOTS_PER_EPOCH

    @classmethod
    def bytes_per_blob(cls) -> int:
        return 32 * cls.FIELD_ELEMENTS_PER_BLOB

    @classmethod
    def field_elements_per_cell(cls) -> int:
        # the 2x-extended blob split evenly across the columns
        return 2 * cls.FIELD_ELEMENTS_PER_BLOB // cls.NUMBER_OF_COLUMNS

    @classmethod
    def bytes_per_cell(cls) -> int:
        return 32 * cls.field_elements_per_cell()


class MainnetEthSpec(EthSpec):
    pass


class MinimalEthSpec(EthSpec):
    """Minimal preset (consensus/types/src/eth_spec.rs:420 equivalent)."""

    NAME = "minimal"

    MAX_COMMITTEES_PER_SLOT = 4
    TARGET_COMMITTEE_SIZE = 4
    SHUFFLE_ROUND_COUNT = 10

    SLOTS_PER_EPOCH = 8
    EPOCHS_PER_ETH1_VOTING_PERIOD = 4
    SLOTS_PER_HISTORICAL_ROOT = 64

    EPOCHS_PER_HISTORICAL_VECTOR = 64
    EPOCHS_PER_SLASHINGS_VECTOR = 64
    HISTORICAL_ROOTS_LIMIT = 2**24

    SYNC_COMMITTEE_SIZE = 32
    EPOCHS_PER_SYNC_COMMITTEE_PERIOD = 8

    MAX_WITHDRAWALS_PER_PAYLOAD = 4
    MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP = 16

    FIELD_ELEMENTS_PER_BLOB = 4096
    MAX_BLOB_COMMITMENTS_PER_BLOCK = 16
    KZG_COMMITMENT_INCLUSION_PROOF_DEPTH = 9


class GnosisEthSpec(EthSpec):
    """Gnosis chain preset (consensus/types/src/eth_spec.rs:481-535): mainnet
    list shapes except 16-slot epochs and 8 withdrawals per payload."""

    NAME = "gnosis"

    SLOTS_PER_EPOCH = 16
    MAX_WITHDRAWALS_PER_PAYLOAD = 8
    EPOCHS_PER_SYNC_COMMITTEE_PERIOD = 512


_PRESETS = {
    "mainnet": MainnetEthSpec,
    "minimal": MinimalEthSpec,
    "gnosis": GnosisEthSpec,
}


def preset_from_name(name: str) -> type[EthSpec]:
    return _PRESETS[name]
