"""Hash-to-curve for G2: expand_message_xmd + SSWU + 3-isogeny + cofactor.

Follows the RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_ construction used by the
eth2 signing spec (DST at the reference's crypto/bls/src/impls/blst.rs:13):
hash_to_field over Fq2 (L=64, m=2, count=2), simplified SWU onto the
isogenous curve E': y² = x³ + 240u·x + 1012(1+u) with Z = -(2+u), then a
3-isogeny to E2: y² = x³ + 4(1+u), then clear the cofactor.

The 3-isogeny is NOT a memorized constant table: E' has a unique rational
3-isogeny kernel over Fq2 (x0 = -6+6u, the only Fq2-rational root of the
3-division polynomial — derived via Vélu's formulas; see tests). Vélu's maps
land on y² = x³ + 4ξ·3⁶, and composing with (x,y) ↦ (x/9, -y/27) gives E2
with exactly RFC 9380 Appendix E.3's normalization: expanding
x_num = (x·d² + t·d + u)/9 over d = x - x0 reproduces the RFC's k_(1,i)
table coefficient-for-coefficient (k_(1,3) = 1/9 mod p, x_den = d²,
y_den = d³, y_num leading coefficient = -1/27 mod p — note the NEGATED y,
RFC k_(3,3) ≡ -1/27). tests/test_hash_to_curve.py pins the expansion against
the RFC constants and the BLS12381G2_XMD:SHA-256_SSWU_RO_ known-answer
vectors.
"""

from __future__ import annotations

import hashlib

from . import fields as F
from .curve import FQ2, g2_clear_cofactor
from .fields import P

# eth2 proof-of-possession ciphersuite DST (impls/blst.rs:13)
DST_G2_POP = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# --- SSWU curve E' parameters (RFC 9380 §8.8.2) ----------------------------
_A = (0, 240)
_B = (1012, 1012)
_Z = (-2 % P, -1 % P)  # -(2 + u)

# --- 3-isogeny E' → E2, derived via Vélu (see module docstring) ------------
_X0 = (-6 % P, 6)  # kernel x-coordinate
# t = 6·x0² + 2A, u = 4·(x0³ + A·x0 + B) — Vélu sums for the ± kernel pair
_T = F.f2_add(F.f2_mul_scalar(F.f2_sqr(_X0), 6), F.f2_mul_scalar(_A, 2))
_U = F.f2_mul_scalar(
    F.f2_add(F.f2_add(F.f2_mul(F.f2_sqr(_X0), _X0), F.f2_mul(_A, _X0)), _B), 4
)
_INV9 = F.f2_inv((9, 0))
_INV27 = F.f2_inv((27, 0))


def _isogeny_to_e2(x, y):
    """Evaluate the 3-isogeny at an affine E' point; returns affine E2 point.

    φx = (x + t/(x-x0) + u/(x-x0)²) / 9
    φy = y·(1 - t/(x-x0)² - 2u/(x-x0)³) / 27
    """
    d = F.f2_sub(x, _X0)
    d_inv = F.f2_inv(d)
    d_inv2 = F.f2_sqr(d_inv)
    d_inv3 = F.f2_mul(d_inv2, d_inv)
    phi_x = F.f2_add(F.f2_add(x, F.f2_mul(_T, d_inv)), F.f2_mul(_U, d_inv2))
    phi_x = F.f2_mul(phi_x, _INV9)
    deriv = F.f2_sub(
        F.f2_sub(F.F2_ONE, F.f2_mul(_T, d_inv2)),
        F.f2_mul(F.f2_mul_scalar(_U, 2), d_inv3),
    )
    # RFC 9380 E.3 normalization: y-map is NEGATED relative to the plain
    # Vélu/27 composition (k_(3,3) = -1/27 mod p).
    phi_y = F.f2_neg(F.f2_mul(F.f2_mul(y, deriv), _INV27))
    return phi_x, phi_y


# ---------------------------------------------------------------------------
# expand_message_xmd / hash_to_field (RFC 9380 §5)
# ---------------------------------------------------------------------------

_B_IN_BYTES = 32  # SHA-256 output
_S_IN_BYTES = 64  # SHA-256 block
_L = 64  # ceil((381 + 128) / 8)


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = (len_in_bytes + _B_IN_BYTES - 1) // _B_IN_BYTES
    if ell > 255:
        raise ValueError("expand_message_xmd: output too long")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = b"\x00" * _S_IN_BYTES
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    blocks = [b1]
    for i in range(2, ell + 1):
        prev = blocks[-1]
        mixed = bytes(a ^ b for a, b in zip(b0, prev))
        blocks.append(hashlib.sha256(mixed + i.to_bytes(1, "big") + dst_prime).digest())
    return b"".join(blocks)[:len_in_bytes]


def hash_to_field_fq2(msg: bytes, count: int, dst: bytes) -> list:
    """RFC 9380 hash_to_field with m=2, L=64."""
    len_in_bytes = count * 2 * _L
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    out = []
    for i in range(count):
        coords = []
        for j in range(2):
            offset = _L * (j + i * 2)
            coords.append(int.from_bytes(uniform[offset : offset + _L], "big") % P)
        out.append(tuple(coords))
    return out


# ---------------------------------------------------------------------------
# Simplified SWU map (RFC 9380 §6.6.2, straightforward variant)
# ---------------------------------------------------------------------------

_MINUS_B_OVER_A = F.f2_mul(F.f2_neg(_B), F.f2_inv(_A))
_B_OVER_ZA = F.f2_mul(_B, F.f2_inv(F.f2_mul(_Z, _A)))


def map_to_curve_sswu(u):
    """Map an Fq2 element to an affine point on E'."""
    z_u2 = F.f2_mul(_Z, F.f2_sqr(u))
    tv = F.f2_add(F.f2_sqr(z_u2), z_u2)  # Z²u⁴ + Zu²
    if F.f2_is_zero(tv):
        x1 = _B_OVER_ZA
    else:
        x1 = F.f2_mul(_MINUS_B_OVER_A, F.f2_add(F.F2_ONE, F.f2_inv(tv)))
    gx1 = F.f2_add(F.f2_add(F.f2_mul(F.f2_sqr(x1), x1), F.f2_mul(_A, x1)), _B)
    # Try √gx1 directly — f2_sqrt returns None for non-squares, so the
    # separate Legendre pre-check (an extra Fq exponentiation per map) is
    # redundant; SSWU guarantees gx2 is square whenever gx1 is not.
    y = F.f2_sqrt(gx1)
    if y is not None:
        x = x1
    else:
        x2 = F.f2_mul(z_u2, x1)
        gx2 = F.f2_add(F.f2_add(F.f2_mul(F.f2_sqr(x2), x2), F.f2_mul(_A, x2)), _B)
        x, y = x2, F.f2_sqrt(gx2)
    if F.f2_sgn0(u) != F.f2_sgn0(y):
        y = F.f2_neg(y)
    return x, y


# ---------------------------------------------------------------------------
# Full hash_to_curve
# ---------------------------------------------------------------------------


def hash_to_g2(msg: bytes, dst: bytes = DST_G2_POP):
    """Hash a message to a G2 point (Jacobian over Fq2), eth2 ciphersuite."""
    u0, u1 = hash_to_field_fq2(msg, 2, dst)
    q0 = _isogeny_to_e2(*map_to_curve_sswu(u0))
    q1 = _isogeny_to_e2(*map_to_curve_sswu(u1))
    # Add the two E2 points (affine, a=0 curve), then clear cofactor.
    from .curve import from_affine, pt_add

    s = pt_add(FQ2, from_affine(FQ2, q0), from_affine(FQ2, q1))
    return g2_clear_cofactor(s)
