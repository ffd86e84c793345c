"""DataColumnSidecar assembly and verification.

A column sidecar is the transpose of the blob matrix: column j carries
cell j of EVERY blob in the block, all the block's commitments, one
proof per cell, and a single inclusion proof for the whole commitments
list against the header's body root (the per-blob sidecar proves one
commitment; the column already ships the full list, so only the list's
membership needs proving — KZG_COMMITMENTS_INCLUSION_PROOF_DEPTH).

`verify_data_column_sidecars` is the gossip/RPC acceptance gate:
structural checks per sidecar (cheap, attributable) and then ONE
`verify_cell_kzg_proof_batch` across every cell of every sidecar — a
whole block's worth of columns costs two MSMs and a pairing, not
columns x blobs pairings.
"""

from __future__ import annotations

from ..crypto.kzg import KzgError
from ..metrics import inc_counter
from ..ssz.merkle_proof import (
    compute_commitments_inclusion_proof,
    verify_commitments_inclusion_proof,
)
from .erasure import cells_from_extended, recover_extended
from .proofs import (
    cell_to_fr,
    compute_cells_and_proofs,
    fr_to_cell,
    verify_cell_kzg_proof_batch,
)


def build_data_column_sidecars(signed_block, blobs, kzg, E) -> list:
    """All NUMBER_OF_COLUMNS sidecars for a block's blobs (proposer
    side). Empty when the block carries no blobs — a blobless block has
    nothing to sample."""
    from ..types.containers import build_types

    if not blobs:
        return []
    t = build_types(E)
    body = signed_block.message.body
    commitments = [bytes(c) for c in body.blob_kzg_commitments]
    if len(commitments) != len(blobs):
        raise KzgError("blob count does not match block commitments")
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
    inclusion = compute_commitments_inclusion_proof(body, E)
    per_blob = [
        compute_cells_and_proofs(blob, kzg, E.NUMBER_OF_COLUMNS, commitment=c)
        for blob, c in zip(blobs, commitments)
    ]
    out = []
    for j in range(E.NUMBER_OF_COLUMNS):
        out.append(
            t.DataColumnSidecar(
                index=j,
                column=[cells[j] for cells, _proofs, _c in per_blob],
                kzg_commitments=commitments,
                kzg_proofs=[proofs[j] for _cells, proofs, _c in per_blob],
                signed_block_header=signed_header,
                kzg_commitments_inclusion_proof=inclusion,
            )
        )
    return out


def verify_data_column_sidecar(sidecar, E) -> None:
    """Structural gate for one sidecar (no crypto beyond the Merkle
    branch): index range, aligned row counts, inclusion proof. Raises
    ValueError — these are proven-invalid conditions, attributable to
    whoever forwarded the sidecar."""
    index = int(sidecar.index)
    if index >= E.NUMBER_OF_COLUMNS:
        raise ValueError(f"column index {index} out of range")
    rows = len(sidecar.column)
    if rows == 0:
        raise ValueError("empty data column")
    if len(sidecar.kzg_commitments) != rows or len(sidecar.kzg_proofs) != rows:
        raise ValueError("column/commitments/proofs length mismatch")
    if not verify_commitments_inclusion_proof(sidecar, E):
        raise ValueError("commitments inclusion proof invalid")


def sidecar_cells(sidecar) -> list:
    """The sidecar's rows as batch-verifier items: (commitment,
    column_index, cell_bytes, proof) per blob row."""
    index = int(sidecar.index)
    return [
        (bytes(c), index, bytes(cell), bytes(proof))
        for c, cell, proof in zip(
            sidecar.kzg_commitments, sidecar.column, sidecar.kzg_proofs
        )
    ]


def verify_data_column_sidecars(sidecars, kzg, E) -> None:
    """Acceptance gate for a batch of sidecars (one block's columns, or a
    segment's): structural checks per sidecar, then one RLC pairing over
    every cell. Raises ValueError on any failure."""
    items = []
    for sidecar in sidecars:
        verify_data_column_sidecar(sidecar, E)
        items.extend(sidecar_cells(sidecar))
    if not items:
        return
    if kzg is None:
        raise ValueError("no KZG engine configured for data columns")
    try:
        ok = verify_cell_kzg_proof_batch(items, kzg)
    except KzgError as e:
        raise ValueError(f"malformed data column cell: {e}") from e
    if not ok:
        raise ValueError(
            f"cell KZG batch verification failed across {len(items)} cells"
        )


def recover_matrix(sidecars, E) -> dict:
    """Reconstruct the FULL cell matrix from any >=50% of a block's
    (already KZG-verified) column sidecars: column index -> list of cell
    bytes, one per blob row, for every one of NUMBER_OF_COLUMNS columns.

    The inputs must be verified columns of one block: each row's >=50%
    verified cells pin a unique degree-<n polynomial (the recovery degree
    check enforces consistency), so the reconstructed cells need no
    re-verification against the commitments. ErasureError propagates when
    the subset is short or inconsistent."""
    by_col = {}
    for sc in sidecars:
        by_col[int(sc.index)] = sc
    if not by_col:
        raise ValueError("no column sidecars to recover from")
    rows = len(next(iter(by_col.values())).column)
    full: dict[int, list[bytes]] = {
        c: [] for c in range(E.NUMBER_OF_COLUMNS)
    }
    for b in range(rows):
        known = {
            col: cell_to_fr(bytes(sc.column[b])) for col, sc in by_col.items()
        }
        ext = recover_extended(known, E.NUMBER_OF_COLUMNS)
        for c, cell in enumerate(cells_from_extended(ext, E.NUMBER_OF_COLUMNS)):
            full[c].append(fr_to_cell(cell))
    inc_counter("das_reconstructions_total", 1.0)
    return full


def blobs_from_matrix(matrix: dict, E) -> list[bytes]:
    """The original blobs from a full cell matrix: the extended vector's
    first half IS the blob (bit-reversal maps the original domain onto
    the leading cells), so blob b is columns [0, NUMBER_OF_COLUMNS/2)
    of row b concatenated."""
    half = E.NUMBER_OF_COLUMNS // 2
    rows = len(matrix[0])
    return [
        b"".join(bytes(matrix[c][b]) for c in range(half)) for b in range(rows)
    ]
