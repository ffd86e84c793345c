"""Optimal ate pairing on BLS12-381 — optimized host path.

The multi-pairing (product of Miller loops, one shared final exponentiation)
is the primitive behind batch signature verification — the role of blst's
`verify_multiple_aggregate_signatures` in the reference
(crypto/bls/src/impls/blst.rs:112-114).

This is the fast rewrite of `pairing_reference.py` (kept as the differential
oracle). Two structural changes, both standard in the pairing literature:

* **Sparse-line Miller loop on the twist** (Aranha et al., EUROCRYPT 2011;
  step formulas after Costello–Lange–Naehrig, eprint 2010/354): the G2 point
  never leaves Fq2. It is kept in homogeneous projective coordinates
  (inversion-free doubling/addition), and each line evaluation is an Fq12
  element with only three nonzero Fq2 coefficients, folded into the
  accumulator by `fields.f12_mul_by_045`.

  Line derivation for this tower (w² = v, v³ = ξ; untwist
  (x, y) ↦ (x·w⁻², y·w⁻³) with w⁻² = v²/ξ, w⁻³ = vw/ξ): the line through
  untwisted points with twist-slope m, evaluated at embedded P = (x_P, y_P),
  is  l = −y_P + (m·x_P/ξ)·v²w + ((y_T − m·x_T)/ξ)·vw.  Scaling by any Fq2
  factor (denominators, ξ, projective Z powers) is free — such factors lie
  in a proper subfield and are killed by the final exponentiation — which is
  what makes the inversion-free projective form possible. `miller_loop`
  therefore matches the reference only *after* final exponentiation; the
  full `pairing` matches it exactly.

* **Cyclotomic final exponentiation** (Scott et al., Pairing 2009): after
  the easy part the value lies in the cyclotomic subgroup, where
  Granger–Scott compressed squaring applies and conjugation is inversion.
  The hard part uses the x-power addition chain from the identity

      (p⁴ − p² + 1)/r = [(x−1)/3]·(x−1)·(x + p)·(x² + p² − 1) + 1

  ((x−1) ≡ 0 mod 3 for BLS12-381, so every factor is integral and the
  result is the *exact* pairing value, not the cubed variant some
  implementations use; the card's kernel (csrc/bls381_pairing.cu) computes
  the same exact value). Asserted against the
  generic exponent below and differentially tested on random points.
"""

from __future__ import annotations

from . import fields as F
from .curve import B2, FQ, FQ2, to_affine
from .fields import P, R, X

_ATE_LOOP = abs(X)  # 0xd201000000010000
_ATE_BITS = bin(_ATE_LOOP)[3:]  # MSB-first tail (after the leading 1)

# ---------------------------------------------------------------------------
# Miller loop: projective G2 on the twist, sparse Fq12 lines
# ---------------------------------------------------------------------------


def _dbl_step(T, xp, yp):
    """Double T (homogeneous projective on E'(Fq2)) and evaluate the tangent
    line at the embedded G1 point (xp, yp). Returns (2T, (c0, c4, c5))."""
    Xc, Yc, Zc = T
    a = F.f2_half(F.f2_mul(Xc, Yc))
    b = F.f2_sqr(Yc)
    c = F.f2_sqr(Zc)
    e = F.f2_mul(B2, F.f2_add(F.f2_add(c, c), c))  # 3b'·Z²
    f3 = F.f2_add(F.f2_add(e, e), e)
    g = F.f2_half(F.f2_add(b, f3))
    h = F.f2_sub(F.f2_sqr(F.f2_add(Yc, Zc)), F.f2_add(b, c))  # 2YZ
    i = F.f2_sub(e, b)  # 3b'Z² − Y²
    j = F.f2_sqr(Xc)
    e2 = F.f2_sqr(e)
    x3 = F.f2_mul(a, F.f2_sub(b, f3))
    y3 = F.f2_sub(F.f2_sqr(g), F.f2_add(F.f2_add(e2, e2), e2))
    z3 = F.f2_mul(b, h)
    # tangent line, scaled by 2y_T·ξ·Z²/Z³… (any Fq2 factor):
    #   c0 = −2YZ·ξ·y_P, c4 = 3b'Z² − Y², c5 = 3X²·x_P
    c0 = F.f2_mul_xi(F.f2_mul_scalar(F.f2_neg(h), yp))
    j3 = F.f2_add(F.f2_add(j, j), j)
    return (x3, y3, z3), (c0, i, F.f2_mul_scalar(j3, xp))


def _add_step(T, q, xp, yp):
    """Mixed addition T += Q (Q affine on the twist) and the chord line at
    the embedded G1 point. Returns (T+Q, (c0, c4, c5))."""
    Xc, Yc, Zc = T
    xq, yq = q
    theta = F.f2_sub(Yc, F.f2_mul(yq, Zc))
    lam = F.f2_sub(Xc, F.f2_mul(xq, Zc))
    cc = F.f2_sqr(theta)
    dd = F.f2_sqr(lam)
    ee = F.f2_mul(lam, dd)
    ff = F.f2_mul(Zc, cc)
    gg = F.f2_mul(Xc, dd)
    hh = F.f2_add(F.f2_sub(ee, F.f2_add(gg, gg)), ff)
    x3 = F.f2_mul(lam, hh)
    y3 = F.f2_sub(F.f2_mul(theta, F.f2_sub(gg, hh)), F.f2_mul(ee, Yc))
    z3 = F.f2_mul(Zc, ee)
    # chord line, scaled by λ·ξ·Z:
    #   c0 = −λ·ξ·y_P, c4 = λ·y_Q − θ·x_Q, c5 = θ·x_P
    jj = F.f2_sub(F.f2_mul(theta, xq), F.f2_mul(lam, yq))
    c0 = F.f2_mul_xi(F.f2_mul_scalar(F.f2_neg(lam), yp))
    return (x3, y3, z3), (c0, F.f2_neg(jj), F.f2_mul_scalar(theta, xp))


def miller_loop(q_aff, p_aff):
    """f_{|x|,Q}(P), conjugated for x < 0. `q_aff` is an affine point on the
    twist E'(Fq2) (NOT untwisted — unlike the reference), `p_aff` an affine
    G1 point over Fq. Returns 1 if either input is infinity. The result
    equals the reference miller_loop only up to a subfield factor; after
    final exponentiation the pairing values agree exactly."""
    if q_aff is None or p_aff is None:
        return F.F12_ONE
    xp, yp = p_aff
    T = (q_aff[0], q_aff[1], F.F2_ONE)
    f = F.F12_ONE
    for bit in _ATE_BITS:
        f = F.f12_sqr(f)
        T, (c0, c4, c5) = _dbl_step(T, xp, yp)
        f = F.f12_mul_by_045(f, c0, c4, c5)
        if bit == "1":
            T, (c0, c4, c5) = _add_step(T, q_aff, xp, yp)
            f = F.f12_mul_by_045(f, c0, c4, c5)
    # x < 0: conjugate (equivalent to inversion after final exponentiation)
    return F.f12_conj(f)


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------

_HARD_EXP = (P**4 - P**2 + 1) // R
_M1 = (1 - X) // 3  # |(x−1)/3| — integral: (x−1) ≡ 0 (mod 3)
_M2 = 1 - X  # |x−1|

# exactness of the x-chain decomposition (derived, not memorized)
assert 3 * _M1 == _M2
assert _M1 * _M2 * (X + P) * (X**2 + P**2 - 1) + 1 == _HARD_EXP


def final_exponentiation(f):
    """f^((p¹²-1)/r) — exact, via cyclotomic hard part."""
    # Easy part: f^(p⁶-1) then ^(p²+1); lands in the cyclotomic subgroup.
    t = F.f12_mul(F.f12_conj(f), F.f12_inv(f))
    t = F.f12_mul(F.f12_frob_n(t, 2), t)
    # Hard part: t^([(x−1)/3]·(x−1)·(x+p)·(x²+p²−1)) · t.  The (x−1)-powers
    # are negative ((x−1) < 0), handled by conjugation; the two x-powers in
    # (x²) cancel signs, so plain |x| chains compose.
    y = F.f12_conj(F.f12_cyclotomic_pow(t, _M1))  # t^((x−1)/3)
    y = F.f12_conj(F.f12_cyclotomic_pow(y, _M2))  # t^((x−1)²/3)
    y = F.f12_mul(
        F.f12_conj(F.f12_cyclotomic_pow(y, _ATE_LOOP)), F.f12_frob(y)
    )  # ^(x+p)
    y2 = F.f12_cyclotomic_pow(F.f12_cyclotomic_pow(y, _ATE_LOOP), _ATE_LOOP)
    y = F.f12_mul(F.f12_mul(y2, F.f12_frob_n(y, 2)), F.f12_conj(y))  # ^(x²+p²−1)
    return F.f12_mul(y, t)


# ---------------------------------------------------------------------------
# Pairing API
# ---------------------------------------------------------------------------


def pairing(p_g1, q_g2):
    """e(P, Q) for P ∈ G1 (Jacobian over Fq), Q ∈ G2 (Jacobian over Fq2)."""
    return final_exponentiation(
        miller_loop(to_affine(FQ2, q_g2), to_affine(FQ, p_g1))
    )


def miller_product(pairs):
    """∏ f_{|x|,Qᵢ}(Pᵢ) for (Pᵢ ∈ G1, Qᵢ ∈ G2-on-the-twist) Jacobian pairs —
    the Miller-loop half of `multi_pairing`, with no final exponentiation.
    Line-function products are independent per pair, so this is the unit the
    batch verifier shards across the host pool: multiply the per-shard
    products, then run `final_exponentiation` once (lock-free pure Python,
    safe in forked workers)."""
    f = F.F12_ONE
    for p_g1, q_g2 in pairs:
        f = F.f12_mul(f, miller_loop(to_affine(FQ2, q_g2), to_affine(FQ, p_g1)))
    return f


def multi_pairing(pairs):
    """∏ e(P_i, Q_i) with a single shared final exponentiation — the
    multi-pairing that batch verification amortizes over."""
    return final_exponentiation(miller_product(pairs))


def pairing_check(pairs) -> bool:
    """∏ e(P_i, Q_i) == 1 — the form every signature verification reduces to."""
    return F.f12_is_one(multi_pairing(pairs))
