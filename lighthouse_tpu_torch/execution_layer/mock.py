"""In-process mock execution layer.

Mirrors beacon_node/execution_layer/src/test_utils/{mock_execution_layer.rs,
execution_block_generator.rs}: an `ExecutionBlockGenerator` maintains a
hash-linked chain of execution blocks (a PoW segment up to the terminal
block, then PoS payloads), builds non-default payloads on request, and
validates payloads it produced — so harness chains can actually cross the
merge and exercise `process_execution_payload`/`process_withdrawals` in the
real import pipeline.

Block hashes are the SSZ `hash_tree_root` of the payload header (the mock
is consensus-side only; the reference's mock likewise computes its own
hashes rather than real keccak RLP hashes, test_utils/mod.rs:100).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from . import (
    EngineState,
    ExecutionLayer,
    ForkchoiceState,
    PayloadAttributes,
    PayloadStatusV1,
    PowBlock,
)


@dataclass
class _ExecBlock:
    block_hash: bytes
    parent_hash: bytes
    block_number: int
    timestamp: int
    is_pos: bool
    total_difficulty: int


class ExecutionBlockGenerator:
    """Hash-linked execution chain (execution_block_generator.rs analog)."""

    def __init__(self, terminal_total_difficulty: int = 0, pow_blocks: int = 1):
        self.blocks: dict[bytes, _ExecBlock] = {}
        self.head_hash = b"\x00" * 32
        self.terminal_total_difficulty = terminal_total_difficulty
        self.terminal_block_hash = b"\x00" * 32
        # Build the PoW segment; the last PoW block is terminal (its TD
        # reaches TTD).
        parent = b"\x00" * 32
        td = 0
        for i in range(pow_blocks):
            td = (
                terminal_total_difficulty
                if i == pow_blocks - 1
                else td + max(1, terminal_total_difficulty // max(pow_blocks, 1))
            )
            h = hashlib.sha256(b"pow" + i.to_bytes(8, "little")).digest()
            self.blocks[h] = _ExecBlock(
                block_hash=h,
                parent_hash=parent,
                block_number=i,
                timestamp=0,
                is_pos=False,
                total_difficulty=td,
            )
            parent = h
        self.terminal_block_hash = parent
        self.head_hash = parent

    def latest(self) -> _ExecBlock:
        return self.blocks[self.head_hash]

    def insert_pos_block(self, payload_header_root: bytes, parent_hash: bytes, number: int, timestamp: int):
        self.blocks[payload_header_root] = _ExecBlock(
            block_hash=payload_header_root,
            parent_hash=parent_hash,
            block_number=number,
            timestamp=timestamp,
            is_pos=True,
            total_difficulty=self.terminal_total_difficulty,
        )
        self.head_hash = payload_header_root


class MockExecutionLayer(ExecutionLayer):
    """Accept-own-payloads engine (mock_execution_layer.rs:12 analog)."""

    def __init__(self, types, E, terminal_total_difficulty: int = 0):
        self.types = types
        self.E = E
        self.generator = ExecutionBlockGenerator(terminal_total_difficulty)
        self.state = EngineState.ONLINE
        self._known_payload_hashes: set[bytes] = set()

    # -- payload production --------------------------------------------------

    def get_payload(self, parent_hash: bytes, attributes: PayloadAttributes, fork):
        from ..types.chain_spec import ForkName

        if parent_hash is None:
            # merge-transition production: build on the terminal PoW block
            parent_hash = self.generator.terminal_block_hash
            parent_number = self.generator.blocks[parent_hash].block_number
        else:
            parent_hash = bytes(parent_hash)
            parent = self.generator.blocks.get(parent_hash)
            # unknown parent (e.g. the zero genesis execution header of a
            # Capella-at-genesis chain): treat as a virtual number-0 root.
            parent_number = parent.block_number if parent is not None else 0

        payload_cls = {
            ForkName.BELLATRIX: self.types.ExecutionPayload,
            ForkName.CAPELLA: self.types.ExecutionPayloadCapella,
            ForkName.DENEB: self.types.ExecutionPayloadDeneb,
            ForkName.ELECTRA: self.types.ExecutionPayloadElectra,
        }.get(fork)
        if payload_cls is None:
            payload_cls = self.types.ExecutionPayloadElectra
        number = parent_number + 1
        # one synthetic transaction so payloads are visibly non-empty
        tx = hashlib.sha256(b"tx" + number.to_bytes(8, "little")).digest()
        kwargs = dict(
            parent_hash=parent_hash,
            fee_recipient=attributes.suggested_fee_recipient,
            state_root=hashlib.sha256(b"state" + number.to_bytes(8, "little")).digest(),
            receipts_root=hashlib.sha256(b"rcpt" + number.to_bytes(8, "little")).digest(),
            prev_randao=attributes.prev_randao,
            block_number=number,
            gas_limit=30_000_000,
            gas_used=21_000,
            timestamp=attributes.timestamp,
            extra_data=b"lighthouse-tpu-mock",
            base_fee_per_gas=7,
            block_hash=b"\x00" * 32,
            transactions=[tx],
        )
        if fork >= ForkName.CAPELLA:
            kwargs["withdrawals"] = list(attributes.withdrawals)
        if fork >= ForkName.DENEB:
            kwargs["blob_gas_used"] = 0
            kwargs["excess_blob_gas"] = 0
        payload = payload_cls(**kwargs)
        block_hash = self._compute_block_hash(
            payload, attributes.parent_beacon_block_root
        )
        payload.block_hash = block_hash
        self._known_payload_hashes.add(block_hash)
        self.generator.insert_pos_block(
            block_hash, parent_hash, number, attributes.timestamp
        )
        return payload

    def _compute_block_hash(self, payload, parent_beacon_block_root) -> bytes:
        """REAL execution block hash: keccak-256 of the RLP header
        reconstructed from the payload (block_hash.rs) — the mock produces
        hashes any mainnet-faithful verifier accepts."""
        from .block_hash import calculate_execution_block_hash

        block_hash, _ = calculate_execution_block_hash(
            payload, parent_beacon_block_root
        )
        return block_hash

    # -- engine API ----------------------------------------------------------

    def notify_new_payload(self, request) -> PayloadStatusV1:
        from .block_hash import verify_payload_block_hash

        if self.state is EngineState.OFFLINE:
            return PayloadStatusV1.SYNCING
        payload = request.execution_payload
        h = bytes(payload.block_hash)
        # real keccak block-hash verification (block_hash.rs): a payload
        # whose claimed hash does not match its RLP header is INVALID
        # regardless of where it came from
        if not verify_payload_block_hash(
            payload, getattr(request, "parent_beacon_block_root", None)
        ):
            return PayloadStatusV1.INVALID
        if h in self._known_payload_hashes:
            return PayloadStatusV1.VALID
        # accept externally-produced payloads that hash-link correctly
        parent = bytes(payload.parent_hash)
        if parent in self.generator.blocks or parent == b"\x00" * 32:
            self._known_payload_hashes.add(h)
            self.generator.insert_pos_block(
                h, parent, int(payload.block_number), int(payload.timestamp)
            )
            return PayloadStatusV1.VALID
        return PayloadStatusV1.SYNCING

    def notify_forkchoice_updated(
        self, forkchoice_state: ForkchoiceState, attributes: PayloadAttributes | None
    ) -> PayloadStatusV1:
        if self.state is EngineState.OFFLINE:
            return PayloadStatusV1.SYNCING
        head = forkchoice_state.head_block_hash
        if head in self.generator.blocks:
            self.generator.head_hash = head
            return PayloadStatusV1.VALID
        return PayloadStatusV1.SYNCING

    def get_pow_block(self, block_hash: bytes) -> PowBlock | None:
        b = self.generator.blocks.get(block_hash)
        if b is None or b.is_pos:
            return None
        return PowBlock(
            block_hash=b.block_hash,
            parent_hash=b.parent_hash,
            total_difficulty=b.total_difficulty,
        )
