"""State transition (counterpart of lighthouse_tpu/state_processing).

Host-side spec logic; the batch-heavy pieces (signature batches, tree
hashing, the epoch sweep) dispatch to the port's kernels on the default
device (lighthouse_tpu_torch/device.py).

The same exports as the JAX package's, except genesis (``genesis.py``,
whose user is the beacon-chain harness, is not ported yet). Electra state
processing is not ported yet either: the entry points raise
NotImplementedError for a state at or after Electra.
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
