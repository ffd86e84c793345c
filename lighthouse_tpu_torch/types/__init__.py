"""Consensus types: presets, runtime config, SSZ containers.

Capability mirror of the reference's `consensus/types` crate (SURVEY.md §2.2).
"""

from .chain_spec import (
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    GENESIS_SLOT,
    ChainSpec,
    Domain,
    ForkName,
    compute_signing_root,
    gnosis_spec,
    mainnet_spec,
    minimal_spec,
    spec_with_forks_at_genesis,
)
from .containers import build_types
from .eth_spec import (
    EthSpec,
    GnosisEthSpec,
    MainnetEthSpec,
    MinimalEthSpec,
    preset_from_name,
)

__all__ = [
    "FAR_FUTURE_EPOCH",
    "GENESIS_EPOCH",
    "GENESIS_SLOT",
    "ChainSpec",
    "Domain",
    "ForkName",
    "compute_signing_root",
    "gnosis_spec",
    "mainnet_spec",
    "minimal_spec",
    "spec_with_forks_at_genesis",
    "build_types",
    "EthSpec",
    "GnosisEthSpec",
    "MainnetEthSpec",
    "MinimalEthSpec",
    "preset_from_name",
]
