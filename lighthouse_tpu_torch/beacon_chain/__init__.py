"""Beacon chain orchestration (beacon_node/beacon_chain equivalent)."""

from .attestation_verification import (
    AttestationError,
    AttestationVerifier,
    ObservedCache,
    VerifiedAggregatedAttestation,
    VerifiedUnaggregatedAttestation,
    is_aggregator,
)
from .chain import (
    BeaconChain,
    BlockError,
    ChainSegmentResult,
    GossipVerifiedBlock,
)
from .harness import BeaconChainHarness
from .op_pool import OperationPool

__all__ = [
    "AttestationError",
    "AttestationVerifier",
    "ObservedCache",
    "VerifiedAggregatedAttestation",
    "VerifiedUnaggregatedAttestation",
    "is_aggregator",
    "BeaconChain",
    "BlockError",
    "ChainSegmentResult",
    "GossipVerifiedBlock",
    "BeaconChainHarness",
    "OperationPool",
]
