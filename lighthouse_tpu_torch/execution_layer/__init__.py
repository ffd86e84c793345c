"""Execution-layer seam: the engine-API surface the beacon chain drives.

Mirrors beacon_node/execution_layer/src/lib.rs — `get_payload` (:807),
`notify_new_payload` (:1346), `notify_forkchoice_updated` — as an abstract
host-side service. The production implementation would speak JSON-RPC with
JWT auth to an execution node over HTTP (engine_api/http.rs); this package
ships the seam plus the in-process `MockExecutionLayer`
(test_utils/mock_execution_layer.rs:12 analog) that the harness and e2e
merge tests drive. Engine state tracking (online/offline upcheck,
lib.rs:599-618) hangs off the same seam.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class PayloadStatusV1(enum.Enum):
    """engine_api PayloadStatus (engine_api.rs new_payload response)."""

    VALID = "VALID"
    INVALID = "INVALID"
    SYNCING = "SYNCING"
    ACCEPTED = "ACCEPTED"
    INVALID_BLOCK_HASH = "INVALID_BLOCK_HASH"


class EngineState(enum.Enum):
    """Watchdog state (execution_layer/src/lib.rs:599-618)."""

    ONLINE = "online"
    OFFLINE = "offline"


@dataclass
class PayloadAttributes:
    """engine_api PayloadAttributes (V1/V2/V3 superset)."""

    timestamp: int
    prev_randao: bytes
    suggested_fee_recipient: bytes = b"\x00" * 20
    withdrawals: list = field(default_factory=list)
    parent_beacon_block_root: bytes | None = None


@dataclass
class ForkchoiceState:
    head_block_hash: bytes
    safe_block_hash: bytes
    finalized_block_hash: bytes


@dataclass
class PowBlock:
    """Terminal PoW-block view (bellatrix fork-choice validate_merge_block)."""

    block_hash: bytes
    parent_hash: bytes
    total_difficulty: int


class ExecutionLayerError(RuntimeError):
    pass


class ExecutionLayer:
    """Abstract engine-API client. Implementations: MockExecutionLayer (in
    process, tests/harness); an HTTP JSON-RPC client would slot in here."""

    state: EngineState = EngineState.ONLINE

    def get_payload(self, parent_hash: bytes, attributes: PayloadAttributes, fork):
        """Build an execution payload on `parent_hash` (lib.rs:807)."""
        raise NotImplementedError

    def notify_new_payload(self, request) -> PayloadStatusV1:
        """Submit a payload for execution validation (lib.rs:1346)."""
        raise NotImplementedError

    def notify_forkchoice_updated(
        self, forkchoice_state: ForkchoiceState, attributes: PayloadAttributes | None
    ) -> PayloadStatusV1:
        raise NotImplementedError

    def get_pow_block(self, block_hash: bytes) -> PowBlock | None:
        """Terminal-block lookup for merge-transition validation."""
        raise NotImplementedError

    # state-transition adapter (process_execution_payload engine hook)
    def verify_and_notify_new_payload(self, request) -> bool:
        status = self.notify_new_payload(request)
        return status in (PayloadStatusV1.VALID, PayloadStatusV1.SYNCING, PayloadStatusV1.ACCEPTED)


from .mock import ExecutionBlockGenerator, MockExecutionLayer  # noqa: E402,F401
