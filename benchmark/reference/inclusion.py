"""The specs' ``is_valid_merkle_branch`` for a blob sidecar's commitment
(Deneb p2p-interface.md ``verify_blob_sidecar_inclusion_proof``), by
``hashlib``."""

from __future__ import annotations

from .ssz import fixed_bytes_root, h

COMMITMENTS_FIELD = 11  # blob_kzg_commitments in the Deneb BeaconBlockBody


def verify_inclusion(commitment: bytes, proof: list[bytes], index: int, body_root: bytes, preset: dict) -> bool:
    """is_valid_merkle_branch for the commitment at `index` of the body."""
    depth = (preset["MAX_BLOB_COMMITMENTS_PER_BLOCK"] - 1).bit_length()
    node = fixed_bytes_root(commitment)
    idx = (COMMITMENTS_FIELD << (depth + 1)) | index
    for sib in proof:
        node = h(sib, node) if idx & 1 else h(node, sib)
        idx >>= 1
    return len(proof) == preset["KZG_COMMITMENT_INCLUSION_PROOF_DEPTH"] and node == body_root
