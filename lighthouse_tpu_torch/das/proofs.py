"""Per-cell KZG proofs and the batched cell verifier (PeerDAS crypto).

Proof scheme — and an honest statement of its scope. The packaged trusted
setups carry only [G2, tau*G2], which is enough for single-point openings
but NOT for the c-kzg coset-vanishing check (that needs [tau^fe]G2): a
faithful FK20 cell proof is out of reach without regenerating every
setup. Instead a cell's proof is a single-point opening at one
Fiat-Shamir-selected point of the cell's 64-point coset — the point index
is `sha256(domain || commitment || cell_index || cell_bytes) % fe`, so a
prover must commit to the cell's claimed bytes before learning which
point is checked. A forged cell passes with probability (fe-1)/fe per
attempt (grindable), versus cryptographically negligible for the real
scheme — documented, deliberate fidelity cut; every OTHER property
(extension math, recovery, batching, custody, sampling) is spec-shaped.

Batch verification is the EIP-4844 RLC collapse ported to cells: with
per-item challenge powers r_i, the n pairing equations
  e(C_i - y_i*G1 + z_i*pi_i, -G2) * e(pi_i, tau*G2) == 1
sum into ONE equation whose two sides are Pippenger MSMs over the proof
points (crypto/bls12_381/msm) sharded across the host fork pool, plus a
single pairing check. The per-cell scalar path (`verify_cell_kzg_proof`)
stays as the differential oracle.

Proof COMPUTATION has a dev-tau fast path: `TrustedSetup.insecure_dev`
derives tau deterministically, and when the setup's [tau]G2 matches that
known tau (checked once, cached on the setup object) each proof is one
scalar mul [(p(tau)-y)/(tau-z)]G1 instead of a 4096-point MSM — the
difference between seconds and hours at mainnet blob counts. Ceremony
setups (tau unknown) take the honest quotient-MSM path. Verification
never shortcuts: it is the same pairing math for every setup.

Pool workers (`_msm_shard`, `_prove_shard`) are module-level and pure —
no metrics, no logging, no spans, no torch (a forked child never touches
CUDA); counters are incremented parent-side only.
"""

from __future__ import annotations

import hashlib

from ..crypto.bls12_381 import FQ, FQ2, G1_GEN, G2_GEN, inf, pt_add, pt_eq, pt_mul
from ..crypto.bls12_381.curve import g1_from_bytes, g1_to_bytes, pt_neg
from ..crypto.bls12_381.fields import R as FR_MOD
from ..crypto.bls12_381.msm import msm
from ..crypto.bls12_381.pairing import pairing_check
from ..crypto.kzg import (
    KzgError,
    _bit_reverse_permute,
    _blob_to_evals,
    _fr_from_bytes,
    _fr_to_bytes,
    _g1_msm,
    _int_from_hash,
    _root_of_unity,
)
from ..metrics import inc_counter
from ..parallel.host_pool import get_pool, shard
from ..utils.safe_arith import safe_add, safe_mul
from ..utils.tracing import span
from .erasure import _batch_inv, cells_from_extended, extend_evals, ext_roots_brp

#: FS domain for selecting a cell's checked point (16 bytes, kzg style)
DAS_CELL_PROOF_DOMAIN = b"LHTPUDASCELL__V1"
#: FS domain for the batch RLC challenge
DAS_BATCH_CHALLENGE_DOMAIN = b"LHTPUDASBATCH_V1"

#: the insecure_dev tau (crypto/kzg/__init__.py keeps the same literal)
_DEV_TAU = (
    int.from_bytes(hashlib.sha256(b"lighthouse-tpu dev tau").digest(), "big")
    % FR_MOD
)


def cell_to_fr(cell_bytes: bytes) -> list[int]:
    """Parse a cell's 32-byte-big-endian field elements (KzgError on any
    non-canonical element, like `_blob_to_evals`)."""
    if len(cell_bytes) % 32:
        raise KzgError("cell length not a multiple of 32")
    return [
        _fr_from_bytes(cell_bytes[i : i + 32])
        for i in range(0, len(cell_bytes), 32)
    ]


def fr_to_cell(vals: list[int]) -> bytes:
    return b"".join(_fr_to_bytes(v) for v in vals)


def cell_point_index(commitment: bytes, cell_index: int, cell_bytes: bytes) -> int:
    """Which of the cell's fe coset points this proof opens (Fiat-Shamir
    over the cell's full claimed contents)."""
    fe = len(cell_bytes) // 32
    h = hashlib.sha256(
        DAS_CELL_PROOF_DOMAIN
        + bytes(commitment)
        + int(cell_index).to_bytes(8, "big")
        + bytes(cell_bytes)
    ).digest()
    return _int_from_hash(h) % fe


def _cell_opening(
    commitment: bytes, cell_index: int, cell_bytes: bytes, n2: int
) -> tuple[int, int]:
    """(z, y): the FS-selected domain point for this cell and the cell's
    claimed evaluation there."""
    fe = len(cell_bytes) // 32
    k = cell_point_index(commitment, cell_index, cell_bytes)
    z = ext_roots_brp(n2)[safe_add(safe_mul(int(cell_index), fe), k)]
    off = safe_mul(k, 32)
    y = _fr_from_bytes(cell_bytes[off : off + 32])
    return z, y


# ---------------------------------------------------------------------------
# Proof computation
# ---------------------------------------------------------------------------


def _dev_secret(setup):
    """The dev tau iff this setup is the insecure_dev one (g2[1] matches
    tau*G2), else None. One pairing-free group check, cached on the setup."""
    cached = getattr(setup, "_das_dev_tau", False)
    if cached is not False:
        return cached
    tau = (
        _DEV_TAU
        if pt_eq(FQ2, setup.g2_monomial[1], pt_mul(FQ2, G2_GEN, _DEV_TAU))
        else None
    )
    setup._das_dev_tau = tau
    return tau


def _lagrange_at_tau(setup, tau: int) -> list:
    """L_i(tau) in bit-reversed order (same formula insecure_dev uses to
    build its G1 points), cached on the setup object."""
    cached = getattr(setup, "_das_lag_at_tau", None)
    if cached is not None:
        return cached
    n = setup.n
    w = _root_of_unity(n)
    natural = [pow(w, i, FR_MOD) for i in range(n)]
    tn1 = (pow(tau, n, FR_MOD) - 1) % FR_MOD
    n_inv = pow(n, FR_MOD - 2, FR_MOD)
    invs = _batch_inv([(tau - wi) % FR_MOD for wi in natural])
    lag = _bit_reverse_permute(
        [wi * tn1 % FR_MOD * iv % FR_MOD * n_inv % FR_MOD for wi, iv in zip(natural, invs)]
    )
    setup._das_lag_at_tau = lag
    return lag


def _prove_shard(task) -> list[bytes]:
    """Pool worker: dev-tau proofs for one shard of cells — pure group
    math, fork-safe. task = list of (p_tau, y, inv_tau_minus_z)."""
    out = []
    for p_tau, y, inv_tmz in task:
        scalar = (p_tau - y) * inv_tmz % FR_MOD
        out.append(g1_to_bytes(pt_mul(FQ, G1_GEN, scalar)))
    return out


def compute_cells_and_proofs(
    blob: bytes, kzg, columns: int, commitment: bytes | None = None
) -> tuple[list[bytes], list[bytes], bytes]:
    """Extend one blob and produce (cells, proofs, commitment): `columns`
    cell byte-strings and one opening proof per cell."""
    if commitment is None:
        commitment = kzg.blob_to_kzg_commitment(blob)
    evals = _blob_to_evals(blob, kzg.setup.n)
    ext = extend_evals(evals)
    n2 = len(ext)
    cells = [fr_to_cell(c) for c in cells_from_extended(ext, columns)]
    zs, ys = [], []
    for j, cell in enumerate(cells):
        z, y = _cell_opening(commitment, j, cell, n2)
        zs.append(z)
        ys.append(y)
    tau = _dev_secret(kzg.setup)
    if tau is None:
        # honest quotient MSM per cell (ceremony setups; slow but correct)
        proofs = []
        for z, y in zip(zs, ys):
            proof, y_got = kzg.compute_kzg_proof(blob, _fr_to_bytes(z))
            if _fr_from_bytes(y_got) != y:
                raise KzgError("extension disagrees with barycentric eval")
            proofs.append(proof)
        return cells, proofs, commitment
    lag = _lagrange_at_tau(kzg.setup, tau)
    p_tau = 0
    for e, l in zip(evals, lag):
        p_tau = (p_tau + e * l) % FR_MOD
    invs = _batch_inv([(tau - z) % FR_MOD for z in zs])
    tasks = shard(list(zip([p_tau] * columns, ys, invs)), get_pool().size)
    proofs = [p for chunk in get_pool().map(_prove_shard, tasks) for p in chunk]
    return cells, proofs, commitment


# ---------------------------------------------------------------------------
# Verification — scalar oracle and the batched MSM lane
# ---------------------------------------------------------------------------


def verify_cell_kzg_proof(
    commitment: bytes, cell_index: int, cell_bytes: bytes, proof: bytes, kzg
) -> bool:
    """Per-cell scalar oracle: one full pairing check per cell. The
    differential control for the batched lane."""
    cell_to_fr(cell_bytes)  # reject non-canonical elements up front
    z, y = _cell_opening(commitment, cell_index, cell_bytes, 2 * kzg.setup.n)
    ok = kzg.verify_kzg_proof(
        commitment, _fr_to_bytes(z), _fr_to_bytes(y), proof
    )
    inc_counter("das_cells_verified_total", 1.0, path="oracle")
    return ok


def _msm_shard(task):
    """Pool worker: decompress one shard of proof points and return the
    two partial MSMs (lhs z-weighted, rhs r-weighted) as Jacobian points.
    Pure group math — fork-safe. task = (proof_bytes_list, rz_list, r_list)."""
    proof_bytes, rz, rs = task
    pts = [g1_from_bytes(p) for p in proof_bytes]
    return msm(FQ, pts, rz), msm(FQ, pts, rs)


def verify_cell_kzg_proof_batch(items, kzg) -> bool:
    """One RLC pairing check for any number of (commitment, cell_index,
    cell_bytes, proof) items — a whole block's or segment's cells collapse
    into two Pippenger MSMs over the fork-pool lanes plus one pairing.

    Raises KzgError on malformed inputs (non-canonical field elements,
    bad point encodings); returns False when well-formed cells fail the
    pairing equation."""
    items = list(items)
    if not items:
        return True
    n2 = 2 * kzg.setup.n
    with span("da_verify", cells=len(items)):
        with span("da_derive"):
            zs, ys = [], []
            for commitment, cell_index, cell_bytes, _proof in items:
                cell_to_fr(cell_bytes)
                z, y = _cell_opening(commitment, cell_index, cell_bytes, n2)
                zs.append(z)
                ys.append(y)
            data = (
                DAS_BATCH_CHALLENGE_DOMAIN
                + n2.to_bytes(8, "big")
                + len(items).to_bytes(8, "big")
            )
            for (commitment, cell_index, _cell, proof), z, y in zip(items, zs, ys):
                data += (
                    bytes(commitment)
                    + int(cell_index).to_bytes(8, "big")
                    + _fr_to_bytes(z)
                    + _fr_to_bytes(y)
                    + bytes(proof)
                )
            r = _int_from_hash(hashlib.sha256(data).digest()) % FR_MOD
            rs = [pow(r, i, FR_MOD) for i in range(len(items))]
        with span("da_msm"):
            # lhs = MSM(commitments, aggregated r) - (sum r*y)G1
            #       + MSM(proofs, r*z);  rhs = MSM(proofs, r)
            agg: dict[bytes, int] = {}
            for (commitment, *_rest), ri in zip(items, rs):
                key = bytes(commitment)
                agg[key] = (agg.get(key, 0) + ri) % FR_MOD
            c_pts = [g1_from_bytes(c) for c in agg]
            lhs = msm(FQ, c_pts, list(agg.values()))
            y_scalar = 0
            for ri, y in zip(rs, ys):
                y_scalar = (y_scalar + ri * y) % FR_MOD
            lhs = pt_add(FQ, lhs, pt_mul(FQ, G1_GEN, (-y_scalar) % FR_MOD))
            proof_bytes = [bytes(it[3]) for it in items]
            rz = [ri * z % FR_MOD for ri, z in zip(rs, zs)]
            parts = max(1, min(get_pool().size, len(items) // 32))
            tasks = [
                tuple(zip(*chunk))
                for chunk in shard(list(zip(proof_bytes, rz, rs)), parts)
            ]
            rhs = inf(FQ)
            for lhs_part, rhs_part in get_pool().map(_msm_shard, tasks):
                lhs = pt_add(FQ, lhs, lhs_part)
                rhs = pt_add(FQ, rhs, rhs_part)
        with span("da_pairing"):
            ok = pairing_check(
                [(pt_neg(FQ, lhs), G2_GEN), (rhs, kzg.setup.g2_monomial[1])]
            )
    inc_counter("das_cells_verified_total", float(len(items)), path="batched")
    return ok


# _g1_msm is re-exported for tests that cross-check the kzg-internal MSM
# against crypto/bls12_381/msm on identical inputs
__all__ = [
    "DAS_CELL_PROOF_DOMAIN",
    "DAS_BATCH_CHALLENGE_DOMAIN",
    "cell_point_index",
    "cell_to_fr",
    "fr_to_cell",
    "compute_cells_and_proofs",
    "verify_cell_kzg_proof",
    "verify_cell_kzg_proof_batch",
    "_g1_msm",
]
