"""BLS12-381 pairing-friendly curve (host reference implementation).

Everything is derived from the curve parameters (p, r, x) — field towers,
curve groups, pairing, hash-to-curve. No external crypto dependencies.
Validated against: published generator encodings, the reference's interop
keypair golden vectors (common/eth2_interop_keypairs/specs/), and RFC 9380
expand_message_xmd test vectors (see tests/test_bls12_381.py).
"""

from .curve import (
    B1,
    B2,
    FQ,
    FQ2,
    G1_GEN,
    G2_GEN,
    H1,
    H2,
    g1_from_bytes,
    g1_gen_mul,
    g1_in_subgroup,
    g1_is_on_curve,
    g1_to_bytes,
    batch_inv,
    batch_to_affine,
    g2_affine_to_bytes,
    g2_clear_cofactor,
    g2_from_bytes,
    g2_in_subgroup,
    g2_is_on_curve,
    g2_psi,
    g2_to_bytes,
    inf,
    is_inf,
    pt_add,
    pt_double,
    pt_eq,
    pt_mul,
    pt_mul_binary,
    pt_neg,
    to_affine,
)
from .fields import P, R, X
from .fixed_base import FixedBaseTable, fixed_base_window, fixed_base_worthwhile
from .hash_to_curve import DST_G2_POP, hash_to_g2
from .msm import msm, msm_naive
from .pairing import multi_pairing, pairing, pairing_check

__all__ = [
    "P", "R", "X", "B1", "B2", "FQ", "FQ2", "G1_GEN", "G2_GEN", "H1", "H2",
    "g1_from_bytes", "g1_gen_mul", "g1_in_subgroup", "g1_is_on_curve",
    "g1_to_bytes", "batch_inv", "batch_to_affine", "g2_affine_to_bytes",
    "g2_clear_cofactor", "g2_from_bytes", "g2_in_subgroup",
    "g2_is_on_curve", "g2_psi", "g2_to_bytes", "inf", "is_inf", "pt_add",
    "pt_double", "pt_eq", "pt_mul", "pt_mul_binary", "pt_neg", "to_affine",
    "DST_G2_POP", "hash_to_g2", "msm", "msm_naive", "multi_pairing",
    "pairing", "pairing_check", "FixedBaseTable", "fixed_base_window",
    "fixed_base_worthwhile",
]
