"""Network config bundles (common/eth2_network_config analog).

Counterpart of lighthouse_tpu/types/network_config.py, copied.

Loads/saves the standard `config.yaml` key format (UPPER_SNAKE keys,
quoted uint64s, 0x fork versions — consensus-specs configs/*.yaml) into a
runtime ChainSpec, and ships built-in bundles the way the reference
embeds mainnet/gnosis/etc. (built_in_network_configs/)."""

from __future__ import annotations

from dataclasses import replace

import yaml

from .chain_spec import ChainSpec, mainnet_spec, minimal_spec
from .eth_spec import preset_from_name

# config.yaml key <-> ChainSpec field (the subset this node consumes)
_FIELDS = {
    "PRESET_BASE": ("preset_base", str),
    "MIN_GENESIS_ACTIVE_VALIDATOR_COUNT": ("min_genesis_active_validator_count", int),
    "MIN_GENESIS_TIME": ("min_genesis_time", int),
    "GENESIS_FORK_VERSION": ("genesis_fork_version", bytes),
    "GENESIS_DELAY": ("genesis_delay", int),
    "ALTAIR_FORK_VERSION": ("altair_fork_version", bytes),
    "ALTAIR_FORK_EPOCH": ("altair_fork_epoch", int),
    "BELLATRIX_FORK_VERSION": ("bellatrix_fork_version", bytes),
    "BELLATRIX_FORK_EPOCH": ("bellatrix_fork_epoch", int),
    "CAPELLA_FORK_VERSION": ("capella_fork_version", bytes),
    "CAPELLA_FORK_EPOCH": ("capella_fork_epoch", int),
    "DENEB_FORK_VERSION": ("deneb_fork_version", bytes),
    "DENEB_FORK_EPOCH": ("deneb_fork_epoch", int),
    "ELECTRA_FORK_VERSION": ("electra_fork_version", bytes),
    "ELECTRA_FORK_EPOCH": ("electra_fork_epoch", int),
    "SECONDS_PER_SLOT": ("seconds_per_slot", int),
    "SECONDS_PER_ETH1_BLOCK": ("seconds_per_eth1_block", int),
    "MIN_VALIDATOR_WITHDRAWABILITY_DELAY": ("min_validator_withdrawability_delay", int),
    "SHARD_COMMITTEE_PERIOD": ("shard_committee_period", int),
    "ETH1_FOLLOW_DISTANCE": ("eth1_follow_distance", int),
    "EJECTION_BALANCE": ("ejection_balance", int),
    "MIN_PER_EPOCH_CHURN_LIMIT": ("min_per_epoch_churn_limit", int),
    "CHURN_LIMIT_QUOTIENT": ("churn_limit_quotient", int),
    "MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT": ("max_per_epoch_activation_churn_limit", int),
    "MIN_PER_EPOCH_CHURN_LIMIT_ELECTRA": ("min_per_epoch_churn_limit_electra", int),
    "MAX_PER_EPOCH_ACTIVATION_EXIT_CHURN_LIMIT": (
        "max_per_epoch_activation_exit_churn_limit",
        int,
    ),
    "PROPOSER_SCORE_BOOST": ("proposer_score_boost", int),
    "INACTIVITY_SCORE_BIAS": ("inactivity_score_bias", int),
    "INACTIVITY_SCORE_RECOVERY_RATE": ("inactivity_score_recovery_rate", int),
    "DEPOSIT_CHAIN_ID": ("deposit_chain_id", int),
    "DEPOSIT_NETWORK_ID": ("deposit_network_id", int),
    "DEPOSIT_CONTRACT_ADDRESS": ("deposit_contract_address", bytes),
    "GOSSIP_MAX_SIZE": ("gossip_max_size", int),
    "MAX_REQUEST_BLOCKS": ("max_request_blocks", int),
    "MIN_EPOCHS_FOR_BLOCK_REQUESTS": ("min_epochs_for_block_requests", int),
    "TTFB_TIMEOUT": ("ttfb_timeout", int),
    "RESP_TIMEOUT": ("resp_timeout", int),
    "ATTESTATION_PROPAGATION_SLOT_RANGE": ("attestation_propagation_slot_range", int),
}

FAR_FUTURE_EPOCH = 2**64 - 1


class Eth2NetworkConfig:
    """One named network: preset class + runtime ChainSpec."""

    def __init__(self, name: str, spec: ChainSpec, E):
        self.name = name
        self.spec = spec
        self.E = E

    # -- yaml ------------------------------------------------------------------

    @classmethod
    def from_config_yaml(cls, path_or_text, name: str = "custom") -> "Eth2NetworkConfig":
        if isinstance(path_or_text, str) and "\n" not in path_or_text:
            with open(path_or_text) as f:
                doc = yaml.safe_load(f)
        else:
            doc = yaml.safe_load(path_or_text)
        preset_name = str(doc.get("PRESET_BASE", "mainnet")).strip("'\"")
        E = preset_from_name(preset_name)
        base = minimal_spec() if preset_name == "minimal" else mainnet_spec()
        kw = {}
        for key, (field, typ) in _FIELDS.items():
            if key not in doc:
                continue
            raw = doc[key]
            if typ is bytes:
                if isinstance(raw, str) and raw.startswith("0x"):
                    kw[field] = bytes.fromhex(raw[2:])
                elif isinstance(raw, (bytes, bytearray)):
                    kw[field] = bytes(raw)
                else:
                    kw[field] = int(raw).to_bytes(4, "big")
            elif typ is int:
                v = int(str(raw).strip("'\""))
                if field.endswith("_fork_epoch") and v == FAR_FUTURE_EPOCH:
                    v = None
                kw[field] = v
            else:
                kw[field] = str(raw).strip("'\"")
        return cls(name, replace(base, **kw), E)

    def to_config_yaml(self) -> str:
        out = {}
        for key, (field, typ) in _FIELDS.items():
            v = getattr(self.spec, field, None)
            if v is None:
                if field.endswith("_fork_epoch"):
                    out[key] = str(FAR_FUTURE_EPOCH)
                continue
            if typ is bytes:
                out[key] = "0x" + bytes(v).hex()
            else:
                out[key] = str(v)
        return yaml.safe_dump(out, sort_keys=False)


def built_in_network(name: str) -> Eth2NetworkConfig:
    """Embedded bundles (built_in_network_configs analog): `mainnet` with
    the production fork schedule, `minimal-dev` with every fork at genesis
    for local chains."""
    from .eth_spec import MainnetEthSpec, MinimalEthSpec

    if name == "mainnet":
        return Eth2NetworkConfig("mainnet", mainnet_spec(), MainnetEthSpec)
    if name == "minimal-dev":
        spec = replace(
            minimal_spec(),
            altair_fork_epoch=0,
            bellatrix_fork_epoch=0,
            capella_fork_epoch=0,
            deneb_fork_epoch=0,
        )
        return Eth2NetworkConfig("minimal-dev", spec, MinimalEthSpec)
    raise KeyError(f"unknown built-in network {name!r}")
