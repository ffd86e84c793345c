"""BLS12-381 field tower: Fq, Fq2, Fq6, Fq12.

Pure-Python bigint arithmetic — the host reference implementation behind the
BLS backend seam (the role blst's C/assembly plays for the reference client,
crypto/bls/src/impls/blst.rs). The device (JAX) limb kernels in
`lighthouse_tpu_torch.ops.bls381*` are validated against this module.

Representation (chosen to port directly to fixed-shape device arrays):
  Fq   — int in [0, P)
  Fq2  — tuple (c0, c1)            c0 + c1·u,  u² = -1
  Fq6  — tuple (a0, a1, a2) of Fq2 a0 + a1·v + a2·v², v³ = ξ = u + 1
  Fq12 — tuple (b0, b1) of Fq6     b0 + b1·w,  w² = v

All functions are free functions on these tuples (no classes): minimal
call overhead and a 1:1 mapping onto the vectorized device kernels.
"""

from __future__ import annotations

# Field modulus (381 bits)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Scalar field order (255 bits) — order of G1/G2/GT
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (negative); p = (x-1)²(x⁴-x²+1)/3 + x, r = x⁴-x²+1
X = -0xD201000000010000

assert (X - 1) ** 2 * (X**4 - X**2 + 1) // 3 + X == P
assert X**4 - X**2 + 1 == R

# ---------------------------------------------------------------------------
# Fq2 = Fq[u]/(u² + 1)
# ---------------------------------------------------------------------------

F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (1, 1)  # ξ = u + 1, the Fq6/Fq12 tower non-residue


def f2(c0: int, c1: int = 0):
    return (c0 % P, c1 % P)


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return (-a[0] % P, -a[1] % P)


def f2_conj(a):
    return (a[0], -a[1] % P)


def f2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    # (a0+a1)(b0+b1) - t0 - t1 = a0b1 + a1b0
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def f2_sqr(a):
    a0, a1 = a
    # (a0+a1)(a0-a1), 2a0a1
    return ((a0 + a1) * (a0 - a1) % P, (a0 * a1 * 2) % P)


def f2_mul_scalar(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


_INV2 = (P + 1) // 2  # 1/2 mod P


def f2_half(a):
    return (a[0] * _INV2 % P, a[1] * _INV2 % P)


def f2_mul_xi(a):
    """Multiply by ξ = 1 + u:  (c0 - c1) + (c0 + c1)u."""
    a0, a1 = a
    return ((a0 - a1) % P, (a0 + a1) % P)


def f2_inv(a):
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P
    inv_norm = pow(norm, P - 2, P)
    return (a0 * inv_norm % P, -a1 * inv_norm % P)


def f2_pow(a, e: int):
    result = F2_ONE
    base = a
    while e:
        if e & 1:
            result = f2_mul(result, base)
        base = f2_sqr(base)
        e >>= 1
    return result


def f2_is_zero(a) -> bool:
    return a[0] == 0 and a[1] == 0


def f2_legendre(a) -> int:
    """1 if nonzero square, -1 if non-square, 0 if zero.
    χ(a) over Fq2 = χ_Fq(Norm(a)) since Norm: Fq2* → Fq* is surjective."""
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    if norm == 0:
        return 0
    ls = pow(norm, (P - 1) // 2, P)
    return 1 if ls == 1 else -1


def f2_sqrt(a):
    """Square root in Fq2 (p ≡ 3 mod 4), or None if not a square.

    Complex method: for a = x + yu with y≠0, find n = √(x²+y²) in Fq, then
    t² = (x+n)/2 (or (x-n)/2), root = t + (y/2t)u. For y=0: √x directly or
    √(-x)·u (since u² = -1).
    """
    x, y = a
    if x == 0 and y == 0:
        return (0, 0)
    exp = (P + 1) // 4  # Fq sqrt exponent (p ≡ 3 mod 4)
    if y == 0:
        s = pow(x, exp, P)
        if s * s % P == x:
            return (s, 0)
        s = pow(-x % P, exp, P)
        if s * s % P == (-x) % P:
            return (0, s)
        return None
    norm = (x * x + y * y) % P
    n = pow(norm, exp, P)
    if n * n % P != norm:
        return None
    inv2 = (P + 1) // 2  # 1/2 mod P
    for half in ((x + n) * inv2 % P, (x - n) * inv2 % P):
        t = pow(half, exp, P)
        if t * t % P == half and t != 0:
            root = (t, y * pow(2 * t % P, P - 2, P) % P)
            if f2_sqr(root) == (x % P, y % P):
                return root
    return None


def f2_sgn0(a) -> int:
    """RFC 9380 sgn0 for m=2."""
    s0 = a[0] & 1
    z0 = a[0] == 0
    s1 = a[1] & 1
    return s0 | (int(z0) & s1)


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v³ - ξ)
# ---------------------------------------------------------------------------

F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(a, b):
    return (f2_add(a[0], b[0]), f2_add(a[1], b[1]), f2_add(a[2], b[2]))


def f6_sub(a, b):
    return (f2_sub(a[0], b[0]), f2_sub(a[1], b[1]), f2_sub(a[2], b[2]))


def f6_neg(a):
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(
        t0,
        f2_mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))),
    )
    c1 = f2_add(
        f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)),
        f2_mul_xi(t2),
    )
    c2 = f2_add(
        f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1
    )
    return (c0, c1, c2)


def f6_sqr(a):
    return f6_mul(a, a)


def f6_mul_by_v(a):
    """Multiply by v: (a0, a1, a2) → (ξ·a2, a0, a1)."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), f2_mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    denom = f2_add(
        f2_mul(a0, c0), f2_mul_xi(f2_add(f2_mul(a2, c1), f2_mul(a1, c2)))
    )
    t = f2_inv(denom)
    return (f2_mul(c0, t), f2_mul(c1, t), f2_mul(c2, t))


def f6_is_zero(a) -> bool:
    return all(f2_is_zero(c) for c in a)


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w² - v)
# ---------------------------------------------------------------------------

F12_ZERO = (F6_ZERO, F6_ZERO)
F12_ONE = (F6_ONE, F6_ZERO)


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def f12_neg(a):
    return (f6_neg(a[0]), f6_neg(a[1]))


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_by_v(t1))
    c1 = f6_sub(f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), t0), t1)
    return (c0, c1)


def f12_sqr(a):
    a0, a1 = a
    t = f6_mul(a0, a1)
    c0 = f6_sub(
        f6_sub(f6_mul(f6_add(a0, a1), f6_add(a0, f6_mul_by_v(a1))), t),
        f6_mul_by_v(t),
    )
    c1 = f6_add(t, t)
    return (c0, c1)


def f12_conj(a):
    """Conjugation = f^(p⁶) (the p⁶-power Frobenius)."""
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    a0, a1 = a
    t = f6_inv(f6_sub(f6_sqr(a0), f6_mul_by_v(f6_sqr(a1))))
    return (f6_mul(a0, t), f6_neg(f6_mul(a1, t)))


def f12_pow(a, e: int):
    if e < 0:
        return f12_pow(f12_inv(a), -e)
    result = F12_ONE
    base = a
    while e:
        if e & 1:
            result = f12_mul(result, base)
        base = f12_sqr(base)
        e >>= 1
    return result


def f12_is_one(a) -> bool:
    return a == F12_ONE


# ---------------------------------------------------------------------------
# Sparse Fq12 multiplication (Miller-loop line folding)
# ---------------------------------------------------------------------------
# With the M-type twist and the w²=v tower, a Miller-loop line evaluated at an
# embedded G1 point is sparse in the basis {1, v, v², w, vw, v²w}: only the
# coefficients at 1, vw and v²w are nonzero (see pairing.py for the
# derivation). Folding such an element into the accumulator needs 16 Fq2
# multiplications and ~1/3 the additions of the dense 18-mul f12_mul.


def f12_mul_by_045(f, c0, c4, c5):
    """f · (c0 + c4·vw + c5·v²w) for c0, c4, c5 ∈ Fq2."""
    (a0, a1, a2), (b0, b1, b2) = f
    # (A + Bw)(c0 + L1·w) = (A·c0 + v·(B·L1)) + (A·L1 + B·c0)·w,
    # with L1 = c4·v + c5·v² sparse in Fq6 (5-mul Karatsuba each product).
    ta = (f2_mul(a0, c0), f2_mul(a1, c0), f2_mul(a2, c0))
    tb = (f2_mul(b0, c0), f2_mul(b1, c0), f2_mul(b2, c0))
    c45 = f2_add(c4, c5)

    def _sparse_l1(x0, x1, x2):
        m1 = f2_mul(x1, c4)
        m2 = f2_mul(x2, c5)
        mx = f2_mul(f2_add(x1, x2), c45)
        return (
            f2_mul_xi(f2_sub(f2_sub(mx, m1), m2)),
            f2_add(f2_mul(x0, c4), f2_mul_xi(m2)),
            f2_add(f2_mul(x0, c5), m1),
        )

    al1 = _sparse_l1(a0, a1, a2)
    bl1 = _sparse_l1(b0, b1, b2)
    return (f6_add(ta, f6_mul_by_v(bl1)), f6_add(al1, tb))


# ---------------------------------------------------------------------------
# Cyclotomic-subgroup arithmetic (final-exponentiation hard part)
# ---------------------------------------------------------------------------
# After the easy part f^((p⁶−1)(p²+1)), the result lies in the cyclotomic
# subgroup G_{Φ12}(q) = {f : f^(p⁴−p²+1) = 1}, where Granger–Scott
# compressed squaring applies: viewing Fq12 as Fq4-towered, each of the three
# Fq4 "columns" squares with 3 Fq2 squarings instead of a full f12_sqr.
# Within that subgroup, conjugation is inversion (p⁶ ≡ −1 mod p⁴−p²+1).


def _f4_sqr(a, b):
    """(a + b·s)² in Fq4 = Fq2[s]/(s² − ξ): returns (a² + ξb², 2ab)."""
    t0 = f2_sqr(a)
    t1 = f2_sqr(b)
    return (
        f2_add(f2_mul_xi(t1), t0),
        f2_sub(f2_sub(f2_sqr(f2_add(a, b)), t0), t1),
    )


def f12_cyclotomic_sqr(f):
    """f² for f in the cyclotomic subgroup (Granger–Scott)."""
    (z0, z4, z3), (z2, z1, z5) = f
    t0, t1 = _f4_sqr(z0, z1)
    z0 = f2_add(f2_add(f2_sub(t0, z0), f2_sub(t0, z0)), t0)  # 3t0 − 2z0
    z1 = f2_add(f2_add(f2_add(t1, z1), f2_add(t1, z1)), t1)  # 3t1 + 2z1
    t0b, t1b = _f4_sqr(z2, z3)
    t2, t3 = _f4_sqr(z4, z5)
    z4 = f2_add(f2_add(f2_sub(t0b, z4), f2_sub(t0b, z4)), t0b)
    z5 = f2_add(f2_add(f2_add(t1b, z5), f2_add(t1b, z5)), t1b)
    t0c = f2_mul_xi(t3)
    z2 = f2_add(f2_add(f2_add(t0c, z2), f2_add(t0c, z2)), t0c)
    z3 = f2_add(f2_add(f2_sub(t2, z3), f2_sub(t2, z3)), t2)
    return ((z0, z4, z3), (z2, z1, z5))


def f12_cyclotomic_pow(f, e: int):
    """f^e for f in the cyclotomic subgroup, e > 0: square-and-multiply with
    cyclotomic squarings. For e < 0 use f12_conj of the |e| power (conjugation
    is inversion in the subgroup)."""
    if e < 0:
        return f12_conj(f12_cyclotomic_pow(f, -e))
    if e == 0:
        return F12_ONE
    res = f
    for bit in bin(e)[3:]:
        res = f12_cyclotomic_sqr(res)
        if bit == "1":
            res = f12_mul(res, f)
    return res


# ---------------------------------------------------------------------------
# Frobenius endomorphism (coefficients computed, not memorized)
# ---------------------------------------------------------------------------

# v^p = γ6_1 · v, v^(2p) = γ6_2 · v² with γ6_i = ξ^(i(p-1)/3)
_G6_1 = f2_pow(XI, (P - 1) // 3)
_G6_2 = f2_pow(XI, 2 * (P - 1) // 3)
# w^p = γ12 · w with γ12 = ξ^((p-1)/6)
_G12 = f2_pow(XI, (P - 1) // 6)


def f6_frob(a):
    """a^p for a ∈ Fq6."""
    return (
        f2_conj(a[0]),
        f2_mul(f2_conj(a[1]), _G6_1),
        f2_mul(f2_conj(a[2]), _G6_2),
    )


def f12_frob(a):
    """a^p for a ∈ Fq12."""
    b0 = f6_frob(a[0])
    b1 = f6_frob(a[1])
    # multiply b1 (coefficient of w) by γ12
    b1 = tuple(f2_mul(c, _G12) for c in b1)
    return (b0, b1)


def f12_frob_n(a, n: int):
    for _ in range(n):
        a = f12_frob(a)
    return a
