"""Merkle proofs over SSZ structures (consensus/merkle_proof analog).

Single-leaf branch generation/verification for chunk lists, container
fields, and the composed Deneb blob-sidecar inclusion proof
(`kzg_commitment_inclusion_proof`: commitment → commitments-list root →
body root, depth = body_depth + list_depth + 1 length mixin —
E.KZG_COMMITMENT_INCLUSION_PROOF_DEPTH). The deposit-tree proofs in
state_processing/genesis.py predate this module; new proof surfaces build
on these primitives."""

from __future__ import annotations

from ..utils.hash import ZERO_HASHES, hash32_concat
from .merkle import next_pow_of_two


def compute_merkle_proof(chunks: list[bytes], index: int, limit: int | None = None) -> list[bytes]:
    """Branch for `chunks[index]` within merkleize(chunks, limit)."""
    count = len(chunks)
    if limit is None:
        limit = count
    depth = (next_pow_of_two(limit) - 1).bit_length()
    # build full levels (virtual zero padding beyond count)
    level = list(chunks)
    branch = []
    idx = index
    for d in range(depth):
        sibling = idx ^ 1
        if sibling < len(level):
            branch.append(level[sibling])
        else:
            branch.append(ZERO_HASHES[d])
        nxt = []
        for i in range(0, len(level), 2):
            a = level[i]
            b = level[i + 1] if i + 1 < len(level) else ZERO_HASHES[d]
            nxt.append(hash32_concat(a, b))
        level = nxt
        idx >>= 1
    return branch


def verify_merkle_proof(
    leaf: bytes, branch: list[bytes], depth: int, index: int, root: bytes
) -> bool:
    node = bytes(leaf)
    for d in range(depth):
        sib = bytes(branch[d])
        if (index >> d) & 1:
            node = hash32_concat(sib, node)
        else:
            node = hash32_concat(node, sib)
    return node == bytes(root)


# ---------------------------------------------------------------------------
# Container-level proofs
# ---------------------------------------------------------------------------


def container_field_proof(container, field_name: str) -> tuple[bytes, list[bytes], int]:
    """(field_root, branch, field_index) proving a field against
    container.hash_tree_root()."""
    cls = type(container)
    fields = list(cls._fields.items())
    chunks = [t.hash_tree_root_of(getattr(container, f)) for f, t in fields]
    index = [f for f, _ in fields].index(field_name)
    branch = compute_merkle_proof(chunks, index)
    return chunks[index], branch, index


# ---------------------------------------------------------------------------
# Deneb blob-sidecar inclusion proofs (deneb/p2p-interface.md)
# ---------------------------------------------------------------------------


def _list_depth(limit: int) -> int:
    return (next_pow_of_two(limit) - 1).bit_length()


def compute_blob_inclusion_proof(body, index: int, E) -> list[bytes]:
    """Branch proving body.blob_kzg_commitments[index] against the body
    root: list-element branch, then the length mixin, then the body-field
    branch — matching the sidecar's fixed-depth proof vector."""
    cls = type(body)
    commitments = list(body.blob_kzg_commitments)
    limit = E.MAX_BLOB_COMMITMENTS_PER_BLOCK
    elem_t = cls._fields["blob_kzg_commitments"].ELEM
    leaf_roots = [elem_t.hash_tree_root_of(c) for c in commitments]
    elem_branch = compute_merkle_proof(leaf_roots, index, limit=limit)
    length_leaf = len(commitments).to_bytes(32, "little")
    field_root, field_branch, _fidx = container_field_proof(
        body, "blob_kzg_commitments"
    )
    return elem_branch + [length_leaf] + field_branch


def blob_inclusion_index(index: int, body_cls, E) -> int:
    """The proof's leaf index within the composed tree: [element bits]
    [mixin bit = 0][body-field bits] — shared by producer and verifier so
    the encodings cannot drift."""
    field_index = list(body_cls._fields).index("blob_kzg_commitments")
    list_d = _list_depth(E.MAX_BLOB_COMMITMENTS_PER_BLOCK)
    return index | (field_index << (list_d + 1))


def verify_blob_inclusion_proof(sidecar, E) -> bool:
    """Verify sidecar.kzg_commitment_inclusion_proof against the block
    header's body_root."""
    from ..types.containers import build_types

    t = build_types(E)
    body_root = bytes(sidecar.signed_block_header.message.body_root)
    elem_t = t.BeaconBlockBodyDeneb._fields["blob_kzg_commitments"].ELEM
    leaf = elem_t.hash_tree_root_of(sidecar.kzg_commitment)
    branch = [bytes(b) for b in sidecar.kzg_commitment_inclusion_proof]
    depth = E.KZG_COMMITMENT_INCLUSION_PROOF_DEPTH
    if len(branch) != depth:
        return False
    index = blob_inclusion_index(
        int(sidecar.index), t.BeaconBlockBodyDeneb, E
    )
    return verify_merkle_proof(leaf, branch, depth, index, body_root)


def compute_commitments_inclusion_proof(body, E) -> list[bytes]:
    """Branch proving the WHOLE `blob_kzg_commitments` list root against
    the body root (the PeerDAS DataColumnSidecar proof: one branch for
    the list, not one per commitment — the column carries every
    commitment anyway, so only the list's membership needs proving)."""
    _root, branch, _fidx = container_field_proof(body, "blob_kzg_commitments")
    assert len(branch) == E.KZG_COMMITMENTS_INCLUSION_PROOF_DEPTH
    return branch


def verify_commitments_inclusion_proof(sidecar, E) -> bool:
    """Verify sidecar.kzg_commitments_inclusion_proof: the sidecar's own
    commitments list, re-rooted, must prove into the header's body_root."""
    from ..types.containers import build_types

    t = build_types(E)
    body_root = bytes(sidecar.signed_block_header.message.body_root)
    list_t = t.BeaconBlockBodyDeneb._fields["blob_kzg_commitments"]
    leaf = list_t.hash_tree_root_of(sidecar.kzg_commitments)
    branch = [bytes(b) for b in sidecar.kzg_commitments_inclusion_proof]
    depth = E.KZG_COMMITMENTS_INCLUSION_PROOF_DEPTH
    if len(branch) != depth:
        return False
    index = list(t.BeaconBlockBodyDeneb._fields).index("blob_kzg_commitments")
    return verify_merkle_proof(leaf, branch, depth, index, body_root)


def build_blob_sidecars(signed_block, blobs: list[bytes], kzg, E) -> list:
    """Full BlobSidecar containers for a block's blobs (proofs + header) —
    what the block producer hands to gossip (beacon_chain blob packing)."""
    from ..types.containers import build_types

    t = build_types(E)
    body = signed_block.message.body
    header = t.BeaconBlockHeader(
        slot=signed_block.message.slot,
        proposer_index=signed_block.message.proposer_index,
        parent_root=signed_block.message.parent_root,
        state_root=signed_block.message.state_root,
        body_root=body.hash_tree_root(),
    )
    signed_header = t.SignedBeaconBlockHeader(
        message=header, signature=signed_block.signature
    )
    out = []
    for i, blob in enumerate(blobs):
        commitment = bytes(body.blob_kzg_commitments[i])
        proof = kzg.compute_blob_kzg_proof(blob, commitment)
        out.append(
            t.BlobSidecar(
                index=i,
                blob=blob,
                kzg_commitment=commitment,
                kzg_proof=proof,
                signed_block_header=signed_header,
                kzg_commitment_inclusion_proof=compute_blob_inclusion_proof(
                    body, i, E
                ),
            )
        )
    return out
