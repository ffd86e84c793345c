"""Range-sync segments of blob sidecars, made from the seed.

A segment is `blocks` consecutive blocks whose blob counts are a seeded
order of one fixed list (the same sizes in every segment and every seed).
Each block's header roots a body whose ``blob_kzg_commitments`` hold its
blobs' commitments; each sidecar carries its blob, commitment, proof, the
signed header and the commitment's inclusion proof (Deneb p2p-interface.md).
The blobs are distinct random field elements; their commitments and proofs
come from the program's KZG engine, and the reference checks each one it
samples from scratch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..reference.beacon import block_header_root
from ..reference.ssz import ZERO_HASHES, container, fixed_bytes_root, h, mix_in_length

BODY_FIELDS = 12  # Deneb BeaconBlockBody
COMMITMENTS_FIELD = 11
G2_INFINITY = b"\xc0" + b"\x00" * 95


def blob_bytes(rng: np.random.Generator, count: int, n: int) -> list[bytes]:
    """`count` blobs of n canonical field elements (the top two bits of each
    32-byte big-endian element clear, so each lies below r)."""
    data = rng.integers(0, 256, (count, n, 32), dtype=np.uint8)
    data[:, :, 0] &= 0x3F
    return [bytes(b.tobytes()) for b in data]


def branch(leaves: list[bytes], index: int, depth: int) -> list[bytes]:
    """The Merkle branch of leaf `index` in a tree of 2^depth leaves whose
    first len(leaves) are given and the rest zero."""
    level = list(leaves)
    out = []
    for d in range(depth):
        sib = index ^ 1
        out.append(level[sib] if sib < len(level) else ZERO_HASHES[d])
        if len(level) % 2:
            level.append(ZERO_HASHES[d])
        level = [h(level[i], level[i + 1]) for i in range(0, len(level), 2)]
        index //= 2
    return out


def merkle_root(leaves: list[bytes], depth: int) -> bytes:
    level = list(leaves) or [ZERO_HASHES[0]]
    for d in range(depth):
        if len(level) % 2:
            level.append(ZERO_HASHES[d])
        level = [h(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    return level[0]


@dataclass
class Block:
    header: dict
    root: bytes
    blob_ids: list  # pool indices of its blobs, in order
    proofs: list  # the inclusion proof of each blob's commitment


def make_block(slot: int, proposer: int, parent: bytes, state_root: bytes, other_fields: list[bytes],
               commitments: list[bytes], blob_ids: list[int], preset: dict) -> Block:
    depth = (preset["MAX_BLOB_COMMITMENTS_PER_BLOCK"] - 1).bit_length()
    leaves = [fixed_bytes_root(c) for c in commitments]
    commitments_root = mix_in_length(merkle_root(leaves, depth), len(commitments))
    fields = list(other_fields)
    fields.insert(COMMITMENTS_FIELD, commitments_root)
    body_depth = (BODY_FIELDS - 1).bit_length()
    body_root = container(fields)
    proofs = []
    for i in range(len(commitments)):
        p = branch(leaves, i, depth) + [len(commitments).to_bytes(32, "little")]
        p += branch(fields, COMMITMENTS_FIELD, body_depth)
        proofs.append(p)
    header = {"slot": slot, "proposer_index": proposer, "parent_root": parent, "state_root": state_root, "body_root": body_root}
    return Block(header, block_header_root(header), blob_ids, proofs)
