"""Bellatrix execution-payload processing + merge helpers.

Counterpart of lighthouse_tpu/state_processing/bellatrix.py, copied.

Mirrors per_block_processing's process_execution_payload and the
partially_verify_execution_payload checks (bellatrix/beacon-chain.md;
reference per_block_processing.rs + execution_layer notify_new_payload at
beacon_node/execution_layer/src/lib.rs:1346). Payload *execution* validity
is delegated to an ExecutionEngine — the state transition only checks
consensus-visible fields; the beacon chain supplies its engine-API client
(or a mock in tests) exactly as the reference threads its ExecutionLayer.
"""

from __future__ import annotations

from ..types.chain_spec import ChainSpec, ForkName
from .accessors import get_current_epoch, get_randao_mix


class NewPayloadRequest:
    """What notify_new_payload carries (engine_api NewPayloadRequest)."""

    def __init__(self, execution_payload, versioned_hashes=None, parent_beacon_block_root=None):
        self.execution_payload = execution_payload
        self.versioned_hashes = versioned_hashes
        self.parent_beacon_block_root = parent_beacon_block_root


class NoOpExecutionEngine:
    """Accept-everything engine for pre-merge chains and consensus-only
    tests (the reference's MockExecutionLayer default behavior)."""

    def verify_and_notify_new_payload(self, request: NewPayloadRequest) -> bool:
        return True


DEFAULT_ENGINE = NoOpExecutionEngine()


def is_merge_transition_complete(state) -> bool:
    """spec: state.latest_execution_payload_header != ExecutionPayloadHeader()"""
    header = getattr(state, "latest_execution_payload_header", None)
    if header is None:
        return False
    return header != type(header)()


def is_merge_transition_block(state, body) -> bool:
    """spec: !merge_complete and body.execution_payload != ExecutionPayload()
    (full default-instance comparison, not just block_hash)."""
    payload = getattr(body, "execution_payload", None)
    return (
        not is_merge_transition_complete(state)
        and payload is not None
        and payload != type(payload)()
    )


def is_execution_enabled(state, body) -> bool:
    return is_merge_transition_block(state, body) or is_merge_transition_complete(
        state
    )


def compute_timestamp_at_slot(state, spec: ChainSpec, E) -> int:
    slots_since_genesis = state.slot
    return state.genesis_time + slots_since_genesis * spec.seconds_per_slot


def process_execution_payload(
    state, body, spec: ChainSpec, E, fork: ForkName, engine=None
):
    """Consensus-side payload checks + engine notification, then install the
    payload header into the state."""
    from ..types.containers import build_types
    from .per_block import BlockProcessingError

    payload = body.execution_payload
    # Capella+ asserts the parent-hash linkage unconditionally (the merge
    # transition is long complete); Bellatrix only once transition_complete.
    if fork >= ForkName.CAPELLA or is_merge_transition_complete(state):
        if payload.parent_hash != state.latest_execution_payload_header.block_hash:
            raise BlockProcessingError("payload: parent hash mismatch")
    if payload.prev_randao != get_randao_mix(
        state, get_current_epoch(state, E), E
    ):
        raise BlockProcessingError("payload: prev_randao mismatch")
    if payload.timestamp != compute_timestamp_at_slot(state, spec, E):
        raise BlockProcessingError("payload: timestamp mismatch")
    if fork >= ForkName.DENEB:
        if len(body.blob_kzg_commitments) > E.MAX_BLOBS_PER_BLOCK:
            raise BlockProcessingError("payload: too many blob commitments")

    engine = engine if engine is not None else DEFAULT_ENGINE
    versioned_hashes = None
    parent_beacon_block_root = None
    if fork >= ForkName.DENEB:
        versioned_hashes = [
            kzg_commitment_to_versioned_hash(c)
            for c in body.blob_kzg_commitments
        ]
        # EIP-4788 / engine_newPayloadV3: the being-processed block's
        # parent root (latest_block_header was set by process_block_header)
        parent_beacon_block_root = bytes(state.latest_block_header.parent_root)
    if not engine.verify_and_notify_new_payload(
        NewPayloadRequest(payload, versioned_hashes, parent_beacon_block_root)
    ):
        raise BlockProcessingError("payload: execution engine rejected payload")

    t = build_types(E)
    header_cls = {
        ForkName.BELLATRIX: t.ExecutionPayloadHeader,
        ForkName.CAPELLA: t.ExecutionPayloadHeaderCapella,
        ForkName.DENEB: t.ExecutionPayloadHeaderDeneb,
        ForkName.ELECTRA: t.ExecutionPayloadHeaderElectra,
    }[fork]
    _LIST_ROOTS = {
        "transactions_root": "transactions",
        "withdrawals_root": "withdrawals",
        "deposit_receipts_root": "deposit_receipts",
        "withdrawal_requests_root": "withdrawal_requests",
    }
    fields = {}
    for fname in header_cls._fields:
        src = _LIST_ROOTS.get(fname)
        if src is not None:
            fields[fname] = type(payload)._fields[src].hash_tree_root_of(
                getattr(payload, src)
            )
        else:
            fields[fname] = getattr(payload, fname)
    state.latest_execution_payload_header = header_cls(**fields)


VERSIONED_HASH_VERSION_KZG = b"\x01"


def kzg_commitment_to_versioned_hash(commitment: bytes) -> bytes:
    import hashlib

    return VERSIONED_HASH_VERSION_KZG + hashlib.sha256(bytes(commitment)).digest()[1:]
