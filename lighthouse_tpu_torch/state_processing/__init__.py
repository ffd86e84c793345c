"""State transition (counterpart of lighthouse_tpu/state_processing).

Host-side spec logic; the batch-heavy pieces (signature batches, tree
hashing, the epoch sweep) dispatch to the port's kernels on the default
device (lighthouse_tpu_torch/device.py).

The same exports as the JAX package's, genesis included; every fork up
to Electra (``electra.py``) runs through the same entry points.
"""

from .accessors import (
    committee_cache_at,
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    get_active_validator_indices,
    get_beacon_committee,
    get_beacon_proposer_index,
    get_current_epoch,
    get_previous_epoch,
    get_total_active_balance,
)
from .genesis import (
    DepositTree,
    initialize_beacon_state_from_eth1,
    interop_genesis_state,
    is_valid_genesis_state,
)
from .per_block import (
    BlockProcessingError,
    BlockSignatureStrategy,
    BlockSignatureVerifier,
    ConsensusContext,
    per_block_processing,
)
from .per_epoch import process_epoch
from .per_slot import per_slot_processing, process_slot
from .shuffle import compute_shuffled_index, shuffle_list

__all__ = [
    "committee_cache_at",
    "compute_epoch_at_slot",
    "compute_start_slot_at_epoch",
    "get_active_validator_indices",
    "get_beacon_committee",
    "get_beacon_proposer_index",
    "get_current_epoch",
    "get_previous_epoch",
    "get_total_active_balance",
    "DepositTree",
    "initialize_beacon_state_from_eth1",
    "interop_genesis_state",
    "is_valid_genesis_state",
    "BlockProcessingError",
    "BlockSignatureStrategy",
    "BlockSignatureVerifier",
    "ConsensusContext",
    "per_block_processing",
    "process_epoch",
    "per_slot_processing",
    "process_slot",
    "compute_shuffled_index",
    "shuffle_list",
]
