"""The least work of the cells' traffic, and the card's peaks it is timed
against.

Counts come from what the traffic asks for (sets, distinct messages, dirty
leaves, blobs), never from the launches, shapes or padding of the program,
so a share reads the same work whatever implements it. A field product is
counted at the least 32-bit multiplies of a Montgomery product, an
inversion at the binary extended Euclid's floor (a shift and a subtraction
of the operands and of the cofactor track per bit, no multiplies), a power
to a fixed exponent at the floor of any addition chain, and SHA-256 at the
least 32-bit operations of a compression.

Peaks: NVIDIA H100 SXM, published figures at the 1.98 GHz boost clock and
the full 700 W: 3.35 TB/s of HBM3; 64 32-bit integer multiplies a clock on
each of 132 SMs (CUDA C++ Programming Guide, compute capability 9.0); 128
32-bit operations a clock on each SM (four schedulers of 32 lanes). A card
set below 700 W runs below these; each share is printed beside the power
limit the run read.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 132 * 64 * 1.98e9
INT32_OPS_PER_S = 132 * 128 * 1.98e9

# SHA-256 of one 64-byte row (a Merkle node): two compressions, the second
# over the constant padding block; the least 32-bit operations.
SHA256_ROW_OPS = 2300
# One compression of a long message's 64-byte block.
SHA256_BLOCK_OPS = 1150

# Least 32-bit multiplies of one Montgomery product: 12 limbs for Fq (a*b
# and m*p, each 144 limb products of a low and a high half, and 12 m), 8
# for Fr.
FQ_MUL_OPS = 2 * 144 + 2 * 144 + 12
FR_MUL_OPS = 2 * 64 + 2 * 64 + 8

# Least Fq products of each operation (an Fq2 product is 3, a square 2).
FQ_MULS = {
    "g1_dbl": 7,  # 2M + 5S, a = 0
    "g1_add": 16,  # 11M + 5S
    "g1_madd": 11,  # 7M + 4S, an affine addend
    "g2_dbl": 16,
    "g2_add": 43,
    "g2_madd": 29,
    "subgroup_check": 1166,  # a G2 point, by the endomorphism psi
    "miller_pair": 1780,  # 63 doubling and 5 addition steps of one pair
    "miller_sqr": 62 * 36,  # f^2 each step, shared by every pair
    "final_exp": 7182,
    "hash_to_g2": 4403,  # a message: two SSWU maps, the isogeny, the cofactor
}


def inversion_ops(bits: int, limbs: int) -> int:
    """The binary extended Euclid's floor: per bit one shift and one
    subtraction of the operand pair and of the cofactor pair."""
    return bits * 4 * limbs


def ladder_fq_muls(group: str, bits: int, affine: bool = True) -> float:
    """[k]P for a k of `bits` random bits: bits - 1 doublings and, on
    average, (bits - 1) / 2 additions."""
    add = FQ_MULS[f"{group}_madd" if affine else f"{group}_add"]
    return (bits - 1) * FQ_MULS[f"{group}_dbl"] + (bits - 1) / 2 * add


def least_seconds(fq_muls: float = 0, fr_muls: float = 0, int_ops: float = 0, nbytes: float = 0) -> float:
    """The least time of that work on the card: multiplies at the multiply
    rate, all operations at the issue rate, bytes at the memory rate; the
    largest of the three."""
    muls = fq_muls * FQ_MUL_OPS + fr_muls * FR_MUL_OPS
    return max(muls / INT32_MUL_PER_S, (muls + int_ops) / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# BLS: a batch of signature sets
# ---------------------------------------------------------------------------


def bls_batch_seconds(sets: int, messages: int, rlc_bits: int = 64) -> float:
    """One RLC batch of `sets` single-key sets over `messages` distinct
    messages: each signature's subgroup check, r_i sig_i and r_i pk_i on
    affine points, the sums (one G2 sum, a G1 sum per message), a hash to
    G2 per message, messages + 1 Miller loops and one final exponentiation.
    Signatures and keys arrive compressed; their decompression is not
    counted."""
    if sets == 0:
        return 0.0
    fq = sets * (FQ_MULS["subgroup_check"] + ladder_fq_muls("g2", rlc_bits) + ladder_fq_muls("g1", rlc_bits))
    fq += (sets - 1) * FQ_MULS["g2_add"] + (sets - messages) * FQ_MULS["g1_add"]
    fq += messages * FQ_MULS["hash_to_g2"]
    fq += (messages + 1) * FQ_MULS["miller_pair"] + FQ_MULS["miller_sqr"] + FQ_MULS["final_exp"]
    return least_seconds(fq_muls=fq)


# ---------------------------------------------------------------------------
# KZG: a batch of blob proofs (verify_blob_kzg_proof_batch)
# ---------------------------------------------------------------------------


def kzg_batch_seconds(blobs: int, n: int = 4096) -> float:
    """The least time of the part of one batch of `blobs` blob proofs over
    an n-point domain (verify_blob_kzg_proof_batch) that K8 and K4 compute:
    each blob's barycentric evaluation (a fraction tree of 3n - 3 Fr
    products, z^n by log2 n squarings and the finish, the denominators
    inverted together: 3 products each and one inversion), every blob byte
    read once, and the two-pair pairing check. The Fiat-Shamir hashing, the
    batch challenge's powers and the RLC's G1 multiplications (four 255-bit
    products a blob) run on the host; no kernel is credited with them, and
    their time is in the host's share of each segment call."""
    if blobs == 0:
        return 0.0
    fr = blobs * (3 * n - 3 + (n.bit_length() - 1) + 4 + 3)  # tree, z^n, finish, batch inverse
    fq = 2 * FQ_MULS["miller_pair"] + FQ_MULS["miller_sqr"] + FQ_MULS["final_exp"]
    return least_seconds(fq_muls=fq, fr_muls=fr, int_ops=inversion_ops(255, 8), nbytes=blobs * 32 * n)


# ---------------------------------------------------------------------------
# SHA-256: the dirty paths of a state's writes
# ---------------------------------------------------------------------------


def path_nodes(leaves, depth: int) -> int:
    """Internal nodes on the paths from `leaves` (indices) to the root of a
    tree of 2^depth leaves: each hashed once."""
    idx = np.unique(np.asarray(leaves, dtype=np.int64))
    total = 0
    for _ in range(depth):
        idx = np.unique(idx >> 1)
        total += idx.size
    return total


def list_path_rows(leaves, length_chunks: int, limit_chunks: int) -> int:
    """Rows to re-root a list after writes to chunk `leaves`: the paths in
    the tree over its chunks, one node a level above it up to the limit's
    depth, and the length mix-in."""
    live = max(1, (max(1, length_chunks) - 1).bit_length())
    limit = (max(1, limit_chunks) - 1).bit_length()
    return path_nodes(leaves, live) + max(0, limit - live) + 1


def full_tree_rows(chunks: int) -> int:
    """Rows to root `chunks` leaves afresh: every node over the live ones."""
    rows, m = 0, chunks
    while m > 1:
        m = -(-m // 2)
        rows += m
    return rows


def state_write_rows(w, n: int, fork: str, preset: dict, pending: dict, field_index: dict) -> int:
    """The least SHA-256 rows that re-root a state after one block's writes
    (``inputs.state.Writes``): the dirty paths of the balances, the
    validator records (their container roots and the registry's tree), the
    participation flags and the three root vectors; the pending lists that
    the writes shifted, rebuilt; and the state container's paths."""
    rows = list_path_rows(w.balance_idx // 4, -(-n // 4), 2**40 * 8 // 32)
    changed = [int(i) for i in w.slashed_idx]
    leaf_of = {}
    for i in changed:
        leaf_of.setdefault(i, set()).update((2, 3))
    if w.exit_idx is not None:
        for i in w.exit_idx.tolist():
            leaf_of.setdefault(i, set()).update((6, 7))
    rows += sum(path_nodes(sorted(v), 3) for v in leaf_of.values())
    rows += list_path_rows(sorted(leaf_of), n, 2**40)
    rows += list_path_rows(w.part_idx // 32, -(-n // 32), 2**40 // 32)
    spe = preset["SLOTS_PER_EPOCH"]
    rows += 2 * path_nodes([w.slot % preset["SLOTS_PER_HISTORICAL_ROOT"]], (preset["SLOTS_PER_HISTORICAL_ROOT"] - 1).bit_length())
    rows += path_nodes([(w.slot // spe) % preset["EPOCHS_PER_HISTORICAL_VECTOR"]], (preset["EPOCHS_PER_HISTORICAL_VECTOR"] - 1).bit_length())
    fields = ["slot", "block_roots", "state_roots", "validators", "balances", "randao_mixes", "current_epoch_participation"]
    if fork == "electra":
        fields += ["exit_balance_to_consume", "earliest_exit_epoch", *w.appends]
        for name in w.appends:
            k = pending[name]
            width = {"pending_balance_deposits": 2, "pending_partial_withdrawals": 3}[name]
            element_rows = (1 << (width - 1).bit_length()) - 1
            limit = preset[name.upper() + "_LIMIT"]
            rows += k * element_rows + full_tree_rows(k) + max(0, (limit - 1).bit_length() - (max(k, 1) - 1).bit_length()) + 1
    rows += path_nodes([field_index[f] for f in fields], (len(field_index) - 1).bit_length())
    return rows


# Kernel names (substrings of the profiler's names) of each family.
BLS_KERNELS = (
    "g1_ladder_kernel", "g2_ladder_kernel", "g1_segment_sum_kernel", "g2_segment_sum_kernel",
    "to_affine_kernel", "scalar_mul_kernel", "subgroup_check_kernel", "miller_kernel",
    "pairing_final_kernel", "hash_to_g2_kernel",
)
KZG_KERNELS = ("bary_terms_kernel", "bary_finish_kernel", "miller_kernel", "pairing_final_kernel")
