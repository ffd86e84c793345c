"""Runtime chain configuration + fork schedule + signing domains.

Mirrors consensus/types/src/chain_spec.rs:36 (runtime `ChainSpec`) and the
13 domain constants at chain_spec.rs:16-30. Signing messages are always
`SigningData { object_root, domain }.tree_hash_root()`
(consensus/types/src/signing_data.rs:22-35).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from enum import Enum

from ..ssz.merkle import merkleize
from ..utils.hash import hash32_concat

FAR_FUTURE_EPOCH = 2**64 - 1
GENESIS_EPOCH = 0
GENESIS_SLOT = 0


class Domain:
    """Domain types (chain_spec.rs:16-30 equivalent)."""

    BEACON_PROPOSER = 0
    BEACON_ATTESTER = 1
    RANDAO = 2
    DEPOSIT = 3
    VOLUNTARY_EXIT = 4
    SELECTION_PROOF = 5
    AGGREGATE_AND_PROOF = 6
    SYNC_COMMITTEE = 7
    SYNC_COMMITTEE_SELECTION_PROOF = 8
    CONTRIBUTION_AND_PROOF = 9
    BLS_TO_EXECUTION_CHANGE = 10
    # Spec byte literal 0x00000001; domains serialize little-endian here, so
    # the integer value is 1 << 24 (bytes 00 00 00 01). Also the builder
    # application domain (reference APPLICATION_DOMAIN_BUILDER = 16777216).
    APPLICATION_MASK = 0x01000000
    APPLICATION_BUILDER = 0x01000000


class ForkName(str, Enum):
    """Fork ordering helper (consensus/types/src/fork_name.rs equivalent)."""

    PHASE0 = "phase0"
    ALTAIR = "altair"
    BELLATRIX = "bellatrix"
    CAPELLA = "capella"
    DENEB = "deneb"
    ELECTRA = "electra"

    @property
    def index(self) -> int:
        return _FORK_ORDER.index(self)

    def __ge__(self, other):  # type: ignore[override]
        return self.index >= ForkName(other).index

    def __gt__(self, other):  # type: ignore[override]
        return self.index > ForkName(other).index

    def __le__(self, other):  # type: ignore[override]
        return self.index <= ForkName(other).index

    def __lt__(self, other):  # type: ignore[override]
        return self.index < ForkName(other).index


_FORK_ORDER = [
    ForkName.PHASE0,
    ForkName.ALTAIR,
    ForkName.BELLATRIX,
    ForkName.CAPELLA,
    ForkName.DENEB,
    ForkName.ELECTRA,
]


@dataclass
class ChainSpec:
    """Runtime configuration (mainnet values by default)."""

    config_name: str = "mainnet"
    preset_base: str = "mainnet"

    # --- Genesis ----------------------------------------------------------
    min_genesis_active_validator_count: int = 16384
    min_genesis_time: int = 1606824000
    genesis_fork_version: bytes = b"\x00\x00\x00\x00"
    genesis_delay: int = 604800

    # --- Fork schedule ----------------------------------------------------
    altair_fork_version: bytes = b"\x01\x00\x00\x00"
    altair_fork_epoch: int | None = 74240
    bellatrix_fork_version: bytes = b"\x02\x00\x00\x00"
    bellatrix_fork_epoch: int | None = 144896
    capella_fork_version: bytes = b"\x03\x00\x00\x00"
    capella_fork_epoch: int | None = 194048
    deneb_fork_version: bytes = b"\x04\x00\x00\x00"
    deneb_fork_epoch: int | None = 269568
    electra_fork_version: bytes = b"\x05\x00\x00\x00"
    electra_fork_epoch: int | None = None

    # --- Time parameters --------------------------------------------------
    seconds_per_slot: int = 12
    seconds_per_eth1_block: int = 14
    min_validator_withdrawability_delay: int = 256
    shard_committee_period: int = 256
    eth1_follow_distance: int = 2048

    # --- Validator cycle --------------------------------------------------
    ejection_balance: int = 16 * 10**9
    min_per_epoch_churn_limit: int = 4
    churn_limit_quotient: int = 65536
    max_per_epoch_activation_churn_limit: int = 8

    # --- Electra (EIP-7251 maxeb / churn; chain_spec.rs:186-191) ----------
    min_activation_balance: int = 32 * 10**9
    max_effective_balance_electra: int = 2048 * 10**9
    compounding_withdrawal_prefix_byte: int = 0x02
    min_per_epoch_churn_limit_electra: int = 128 * 10**9
    max_per_epoch_activation_exit_churn_limit: int = 256 * 10**9
    min_slashing_penalty_quotient_electra: int = 4096
    whistleblower_reward_quotient_electra: int = 4096
    unset_deposit_receipts_start_index: int = 2**64 - 1
    full_exit_request_amount: int = 0

    # --- Fork choice ------------------------------------------------------
    proposer_score_boost: int = 40
    reorg_head_weight_threshold: int = 20
    reorg_parent_weight_threshold: int = 160
    reorg_max_epochs_since_finalization: int = 2

    # --- Altair inactivity ------------------------------------------------
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16

    # --- Deposit contract -------------------------------------------------
    deposit_chain_id: int = 1
    deposit_network_id: int = 1
    deposit_contract_address: bytes = bytes.fromhex(
        "00000000219ab540356cbb839cbe05303d7705fa"
    )

    # --- Networking (used by the p2p layer) -------------------------------
    gossip_max_size: int = 10 * 2**20
    max_request_blocks: int = 1024
    min_epochs_for_block_requests: int = 33024
    ttfb_timeout: int = 5
    resp_timeout: int = 10
    attestation_propagation_slot_range: int = 32
    maximum_gossip_clock_disparity_millis: int = 500
    message_domain_invalid_snappy: bytes = b"\x00\x00\x00\x00"
    message_domain_valid_snappy: bytes = b"\x01\x00\x00\x00"

    # ----------------------------------------------------------------------

    def fork_name_at_epoch(self, epoch: int) -> ForkName:
        for name, fork_epoch in (
            (ForkName.ELECTRA, self.electra_fork_epoch),
            (ForkName.DENEB, self.deneb_fork_epoch),
            (ForkName.CAPELLA, self.capella_fork_epoch),
            (ForkName.BELLATRIX, self.bellatrix_fork_epoch),
            (ForkName.ALTAIR, self.altair_fork_epoch),
        ):
            if fork_epoch is not None and epoch >= fork_epoch:
                return name
        return ForkName.PHASE0

    def fork_version_for(self, fork: ForkName) -> bytes:
        return {
            ForkName.PHASE0: self.genesis_fork_version,
            ForkName.ALTAIR: self.altair_fork_version,
            ForkName.BELLATRIX: self.bellatrix_fork_version,
            ForkName.CAPELLA: self.capella_fork_version,
            ForkName.DENEB: self.deneb_fork_version,
            ForkName.ELECTRA: self.electra_fork_version,
        }[fork]

    def fork_epoch_of(self, fork: ForkName) -> int | None:
        return {
            ForkName.PHASE0: 0,
            ForkName.ALTAIR: self.altair_fork_epoch,
            ForkName.BELLATRIX: self.bellatrix_fork_epoch,
            ForkName.CAPELLA: self.capella_fork_epoch,
            ForkName.DENEB: self.deneb_fork_epoch,
            ForkName.ELECTRA: self.electra_fork_epoch,
        }[fork]

    def fork_version_at_epoch(self, epoch: int) -> bytes:
        return self.fork_version_for(self.fork_name_at_epoch(epoch))

    # --- Domains (signing_data.rs / spec.get_domain) ----------------------

    @staticmethod
    def compute_fork_data_root(
        current_version: bytes, genesis_validators_root: bytes
    ) -> bytes:
        # ForkData { current_version: Bytes4, genesis_validators_root: Bytes32 }
        chunk0 = bytes(current_version).ljust(32, b"\x00")
        return merkleize([chunk0, bytes(genesis_validators_root)])

    @staticmethod
    def compute_fork_digest(
        current_version: bytes, genesis_validators_root: bytes
    ) -> bytes:
        return ChainSpec.compute_fork_data_root(
            current_version, genesis_validators_root
        )[:4]

    @staticmethod
    def compute_domain_from_parts(
        domain_type: int, fork_version: bytes, genesis_validators_root: bytes
    ) -> bytes:
        fork_data_root = ChainSpec.compute_fork_data_root(
            fork_version, genesis_validators_root
        )
        return domain_type.to_bytes(4, "little") + fork_data_root[:28]

    def get_domain(
        self,
        epoch: int,
        domain_type: int,
        fork,
        genesis_validators_root: bytes,
    ) -> bytes:
        """`fork` is a Fork container (or None for pre-genesis domains)."""
        if fork is None:
            fork_version = self.genesis_fork_version
        else:
            fork_version = (
                fork.previous_version if epoch < fork.epoch else fork.current_version
            )
        return self.compute_domain_from_parts(
            domain_type, fork_version, genesis_validators_root
        )

    def get_deposit_domain(self) -> bytes:
        """Deposit domain is always computed with genesis fork version and an
        empty genesis_validators_root (deposits predate genesis)."""
        return self.compute_domain_from_parts(
            Domain.DEPOSIT, self.genesis_fork_version, b"\x00" * 32
        )

    # --- Churn ------------------------------------------------------------

    def churn_limit(self, active_validator_count: int) -> int:
        return max(
            self.min_per_epoch_churn_limit,
            active_validator_count // self.churn_limit_quotient,
        )

    def activation_churn_limit(self, active_validator_count: int, fork: ForkName) -> int:
        limit = self.churn_limit(active_validator_count)
        if fork >= ForkName.DENEB:
            limit = min(limit, self.max_per_epoch_activation_churn_limit)
        return limit


def compute_signing_root(object_root: bytes, domain: bytes) -> bytes:
    """SigningData { object_root, domain }.tree_hash_root()
    (consensus/types/src/signing_data.rs:22-35)."""
    return hash32_concat(bytes(object_root), bytes(domain))


def mainnet_spec() -> ChainSpec:
    return ChainSpec()


def minimal_spec() -> ChainSpec:
    """Minimal-preset runtime config (matches consensus-specs configs/minimal)."""
    return ChainSpec(
        config_name="minimal",
        preset_base="minimal",
        min_genesis_active_validator_count=64,
        min_genesis_time=1578009600,
        genesis_fork_version=b"\x00\x00\x00\x01",
        genesis_delay=300,
        altair_fork_version=b"\x01\x00\x00\x01",
        altair_fork_epoch=None,
        bellatrix_fork_version=b"\x02\x00\x00\x01",
        bellatrix_fork_epoch=None,
        capella_fork_version=b"\x03\x00\x00\x01",
        capella_fork_epoch=None,
        deneb_fork_version=b"\x04\x00\x00\x01",
        deneb_fork_epoch=None,
        electra_fork_version=b"\x05\x00\x00\x01",
        electra_fork_epoch=None,
        seconds_per_slot=6,
        eth1_follow_distance=16,
        min_validator_withdrawability_delay=256,
        shard_committee_period=64,
        min_per_epoch_churn_limit=2,
        max_per_epoch_activation_churn_limit=4,
        churn_limit_quotient=32,
        deposit_chain_id=5,
        deposit_network_id=5,
    )


def gnosis_spec() -> ChainSpec:
    return ChainSpec(
        config_name="gnosis",
        preset_base="gnosis",
        seconds_per_slot=5,
        churn_limit_quotient=4096,
        max_per_epoch_activation_churn_limit=2,
        min_genesis_active_validator_count=4096,
        genesis_delay=6000,
        eth1_follow_distance=1024,
        seconds_per_eth1_block=6,
        min_genesis_time=1638968400,
        genesis_fork_version=b"\x00\x00\x00\x64",
        altair_fork_version=b"\x01\x00\x00\x64",
        altair_fork_epoch=512,
        bellatrix_fork_version=b"\x02\x00\x00\x64",
        bellatrix_fork_epoch=385536,
        capella_fork_version=b"\x03\x00\x00\x64",
        capella_fork_epoch=648704,
        deneb_fork_version=b"\x04\x00\x00\x64",
        deneb_fork_epoch=889856,
        electra_fork_version=b"\x05\x00\x00\x64",
        electra_fork_epoch=None,
        deposit_chain_id=100,
        deposit_network_id=100,
    )


def spec_with_forks_at_genesis(base: ChainSpec, through: ForkName) -> ChainSpec:
    """Test helper: schedule every fork up to `through` at epoch 0 (the
    reference's `fork_from_env` per-fork test matrix, Makefile:162-166)."""
    updates = {}
    for fork in _FORK_ORDER[1:]:
        key = f"{fork.value}_fork_epoch"
        updates[key] = 0 if fork <= through else None
    return replace(base, **updates)
