"""Execution block-hash verification.

The reference verifies that a payload's `block_hash` really is the
keccak-256 of the RLP-encoded execution block header reconstructed from
the payload (execution_layer/src/block_hash.rs
calculate_execution_block_hash): the transactions and withdrawals roots
are ordered Merkle-Patricia trie roots, ommers is the empty-list hash,
difficulty is 0 and the nonce zero post-merge, and the fork decides which
trailing fields exist (Capella adds withdrawals_root, Deneb adds
blob_gas_used/excess_blob_gas/parent_beacon_block_root).
"""

from __future__ import annotations

from ..utils.keccak import keccak256
from ..utils.rlp import encode, ordered_trie_root

# keccak256(rlp([])) — the post-merge ommers hash
EMPTY_OMMERS_HASH = bytes.fromhex(
    "1dcc4de8dec75d7aab85b567b6ccd41ad312451b948a7413f0a142fd40d49347"
)
ZERO_NONCE = b"\x00" * 8


def rlp_encode_withdrawal(withdrawal) -> bytes:
    return encode(
        [
            int(withdrawal.index),
            int(withdrawal.validator_index),
            bytes(withdrawal.address),
            int(withdrawal.amount),
        ]
    )


def rlp_encode_header_fields(
    payload,
    transactions_root: bytes,
    withdrawals_root: bytes | None,
    parent_beacon_block_root: bytes | None,
) -> bytes:
    """RLP list of the execution header in yellow-paper + EIP order."""
    fields: list = [
        bytes(payload.parent_hash),
        EMPTY_OMMERS_HASH,
        bytes(payload.fee_recipient),
        bytes(payload.state_root),
        transactions_root,
        bytes(payload.receipts_root),
        bytes(payload.logs_bloom),
        0,  # difficulty: post-merge blocks are difficulty-0
        int(payload.block_number),
        int(payload.gas_limit),
        int(payload.gas_used),
        int(payload.timestamp),
        bytes(payload.extra_data),
        bytes(payload.prev_randao),  # mix_hash
        ZERO_NONCE,
        int(payload.base_fee_per_gas),
    ]
    if withdrawals_root is not None:
        fields.append(withdrawals_root)
    blob_gas_used = getattr(payload, "blob_gas_used", None)
    if blob_gas_used is not None:
        fields.append(int(blob_gas_used))
        fields.append(int(payload.excess_blob_gas))
    if parent_beacon_block_root is not None:
        fields.append(parent_beacon_block_root)
    return encode(fields)


def calculate_execution_block_hash(
    payload, parent_beacon_block_root: bytes | None = None
) -> tuple[bytes, bytes]:
    """(block_hash, transactions_root) for a CL execution payload."""
    transactions_root = ordered_trie_root(
        [bytes(tx) for tx in payload.transactions]
    )
    withdrawals = getattr(payload, "withdrawals", None)
    withdrawals_root = (
        ordered_trie_root([rlp_encode_withdrawal(w) for w in withdrawals])
        if withdrawals is not None
        else None
    )
    if getattr(payload, "blob_gas_used", None) is None:
        parent_beacon_block_root = None  # pre-Deneb headers omit it
    header_rlp = rlp_encode_header_fields(
        payload, transactions_root, withdrawals_root, parent_beacon_block_root
    )
    return keccak256(header_rlp), transactions_root


def verify_payload_block_hash(
    payload, parent_beacon_block_root: bytes | None = None
) -> bool:
    """True when payload.block_hash matches the recomputed keccak hash."""
    computed, _ = calculate_execution_block_hash(
        payload, parent_beacon_block_root
    )
    return computed == bytes(payload.block_hash)
