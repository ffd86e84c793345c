"""Reference (slow) optimal ate pairing on BLS12-381.

This is the original correctness-first host pairing, kept importable as the
differential-test oracle for the optimized path in `pairing.py`:

- G2 points are untwisted into E(Fq12) and the Miller loop runs with affine
  line functions in full Fq12 arithmetic (one `f12_inv` per step — simple,
  and obviously faithful to the textbook line construction).
- Final exponentiation: easy part via Frobenius/conjugate/inverse; hard part
  (p⁴-p²+1)/r by generic square-and-multiply (no addition chains —
  everything is derived from p, r, x).

`tests/test_pairing_fast.py` pins the fast path against this module on
random points; nothing in the node imports it on a hot path.
"""

from __future__ import annotations

from . import fields as F
from .curve import FQ, FQ2, to_affine
from .fields import P, R, X

# ---------------------------------------------------------------------------
# Untwist: E'(Fq2) → E(Fq12)
# ---------------------------------------------------------------------------
# Tower: w² = v, v³ = ξ ⇒ w⁶ = ξ. The M-type twist E': y² = x³ + 4ξ maps to
# E: y² = x³ + 4 via (x, y) ↦ (x·w⁻², y·w⁻³):
#   (y w⁻³)² = y²/ξ = (x³ + 4ξ)/ξ = (x w⁻²)³ + 4.

_W = (F.F6_ZERO, F.F6_ONE)  # w ∈ Fq12
_W2_INV = F.f12_inv(F.f12_sqr(_W))
_W3_INV = F.f12_inv(F.f12_mul(F.f12_sqr(_W), _W))


def _fq2_to_fq12(a):
    return ((a, F.F2_ZERO, F.F2_ZERO), F.F6_ZERO)


def _fq_to_fq12(a: int):
    return (((a % P, 0), F.F2_ZERO, F.F2_ZERO), F.F6_ZERO)


def untwist(aff):
    """Affine E'(Fq2) point → affine E(Fq12) point."""
    if aff is None:
        return None
    x, y = aff
    return (
        F.f12_mul(_fq2_to_fq12(x), _W2_INV),
        F.f12_mul(_fq2_to_fq12(y), _W3_INV),
    )


def embed_g1(aff):
    """Affine E(Fq) point → affine E(Fq12) point."""
    if aff is None:
        return None
    return (_fq_to_fq12(aff[0]), _fq_to_fq12(aff[1]))


# ---------------------------------------------------------------------------
# Miller loop (affine line functions over Fq12)
# ---------------------------------------------------------------------------


def _line(p1, p2, t):
    """Evaluate the line through p1,p2 (affine Fq12 points) at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = F.f12_mul(F.f12_sub(y2, y1), F.f12_inv(F.f12_sub(x2, x1)))
        return F.f12_sub(F.f12_mul(m, F.f12_sub(xt, x1)), F.f12_sub(yt, y1))
    if y1 == y2:
        # tangent: m = 3x²/2y
        x_sq = F.f12_sqr(x1)
        num = F.f12_add(F.f12_add(x_sq, x_sq), x_sq)
        m = F.f12_mul(num, F.f12_inv(F.f12_add(y1, y1)))
        return F.f12_sub(F.f12_mul(m, F.f12_sub(xt, x1)), F.f12_sub(yt, y1))
    # vertical line
    return F.f12_sub(xt, x1)


def _pt_add_affine(p1, p2):
    """Affine addition on E(Fq12) (a=0 curve). Returns None for infinity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 != y2:
            return None
        x_sq = F.f12_sqr(x1)
        m = F.f12_mul(
            F.f12_add(F.f12_add(x_sq, x_sq), x_sq),
            F.f12_inv(F.f12_add(y1, y1)),
        )
    else:
        m = F.f12_mul(F.f12_sub(y2, y1), F.f12_inv(F.f12_sub(x2, x1)))
    x3 = F.f12_sub(F.f12_sub(F.f12_sqr(m), x1), x2)
    y3 = F.f12_sub(F.f12_mul(m, F.f12_sub(x1, x3)), y1)
    return (x3, y3)


_ATE_LOOP = abs(X)  # 0xd201000000010000


def miller_loop(q_aff, p_aff):
    """f_{|x|,Q}(P) for untwisted Q and embedded P (affine Fq12 points).
    Returns an Fq12 element (1 if either input is infinity)."""
    if q_aff is None or p_aff is None:
        return F.F12_ONE
    t = q_aff
    f = F.F12_ONE
    for bit in bin(_ATE_LOOP)[3:]:
        f = F.f12_mul(F.f12_sqr(f), _line(t, t, p_aff))
        t = _pt_add_affine(t, t)
        if bit == "1":
            f = F.f12_mul(f, _line(t, q_aff, p_aff))
            t = _pt_add_affine(t, q_aff)
    # x < 0: conjugate (equivalent to inversion after final exponentiation)
    return F.f12_conj(f)


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------

_HARD_EXP = (P**4 - P**2 + 1) // R


def final_exponentiation(f):
    """f^((p¹²-1)/r)."""
    # Easy part: f^(p⁶-1) then ^(p²+1)
    t = F.f12_mul(F.f12_conj(f), F.f12_inv(f))
    t = F.f12_mul(F.f12_frob_n(t, 2), t)
    # Hard part
    return F.f12_pow(t, _HARD_EXP)


# ---------------------------------------------------------------------------
# Pairing API
# ---------------------------------------------------------------------------


def pairing(p_g1, q_g2):
    """e(P, Q) for P ∈ G1 (Jacobian over Fq), Q ∈ G2 (Jacobian over Fq2)."""
    p_aff = embed_g1(to_affine(FQ, p_g1))
    q_aff = untwist(to_affine(FQ2, q_g2))
    return final_exponentiation(miller_loop(q_aff, p_aff))


def multi_pairing(pairs):
    """∏ e(P_i, Q_i) with a single shared final exponentiation."""
    f = F.F12_ONE
    for p_g1, q_g2 in pairs:
        p_aff = embed_g1(to_affine(FQ, p_g1))
        q_aff = untwist(to_affine(FQ2, q_g2))
        f = F.f12_mul(f, miller_loop(q_aff, p_aff))
    return final_exponentiation(f)


def pairing_check(pairs) -> bool:
    """∏ e(P_i, Q_i) == 1."""
    return F.f12_is_one(multi_pairing(pairs))
