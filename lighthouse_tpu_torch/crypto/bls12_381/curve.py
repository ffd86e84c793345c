"""BLS12-381 elliptic curve groups G1 (over Fq) and G2 (over Fq2).

Generic Jacobian-coordinate arithmetic parameterized by a field-ops adapter,
instantiated for Fq, Fq2 and (for the pairing's untwisted points) Fq12.
Point compression follows the ZCash serialization rules used by the
reference's BLS wire format (crypto/bls: 48-byte G1 / 96-byte G2 compressed).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from . import fields as F
from .fields import P, R, X

# ---------------------------------------------------------------------------
# Field-ops adapters
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FieldOps:
    zero: Any
    one: Any
    add: Callable
    sub: Callable
    neg: Callable
    mul: Callable
    sqr: Callable
    inv: Callable
    is_zero: Callable
    from_int: Callable


FQ = FieldOps(
    zero=0,
    one=1,
    add=lambda a, b: (a + b) % P,
    sub=lambda a, b: (a - b) % P,
    neg=lambda a: -a % P,
    mul=lambda a, b: a * b % P,
    sqr=lambda a: a * a % P,
    inv=lambda a: pow(a, P - 2, P),
    is_zero=lambda a: a == 0,
    from_int=lambda n: n % P,
)

FQ2 = FieldOps(
    zero=F.F2_ZERO,
    one=F.F2_ONE,
    add=F.f2_add,
    sub=F.f2_sub,
    neg=F.f2_neg,
    mul=F.f2_mul,
    sqr=F.f2_sqr,
    inv=F.f2_inv,
    is_zero=F.f2_is_zero,
    from_int=lambda n: (n % P, 0),
)

FQ12 = FieldOps(
    zero=F.F12_ZERO,
    one=F.F12_ONE,
    add=F.f12_add,
    sub=F.f12_sub,
    neg=F.f12_neg,
    mul=F.f12_mul,
    sqr=F.f12_sqr,
    inv=F.f12_inv,
    is_zero=lambda a: a == F.F12_ZERO,
    from_int=lambda n: (((n % P, 0), F.F2_ZERO, F.F2_ZERO), F.F6_ZERO),
)

# ---------------------------------------------------------------------------
# Generic Jacobian point arithmetic
# ---------------------------------------------------------------------------
# A point is (X, Y, Z) in Jacobian coordinates: affine (X/Z², Y/Z³);
# infinity has Z = 0.


def inf(k: FieldOps):
    return (k.one, k.one, k.zero)


def is_inf(k: FieldOps, pt) -> bool:
    return k.is_zero(pt[2])


def to_affine(k: FieldOps, pt):
    """Returns (x, y) or None for infinity."""
    x, y, z = pt
    if k.is_zero(z):
        return None
    zi = k.inv(z)
    zi2 = k.sqr(zi)
    return (k.mul(x, zi2), k.mul(y, k.mul(zi2, zi)))


def batch_inv(k: FieldOps, vals):
    """Montgomery batch inversion: n field inverses for ONE `k.inv` plus
    3(n−1) multiplications. `vals` must be non-zero."""
    prefix = []
    acc = k.one
    for v in vals:
        acc = k.mul(acc, v)
        prefix.append(acc)
    inv_acc = k.inv(acc)
    out = [None] * len(vals)
    for i in range(len(vals) - 1, 0, -1):
        out[i] = k.mul(inv_acc, prefix[i - 1])
        inv_acc = k.mul(inv_acc, vals[i])
    out[0] = inv_acc
    return out


def batch_to_affine(k: FieldOps, pts):
    """`to_affine` over many Jacobian points with ONE field inversion
    (Montgomery batch trick) — identical outputs, so serializations of
    the results are bit-identical to the per-point path. Infinities map
    to None, exactly like `to_affine`."""
    nz = [i for i, pt in enumerate(pts) if not k.is_zero(pt[2])]
    invs = batch_inv(k, [pts[i][2] for i in nz])
    out = [None] * len(pts)
    for i, zi in zip(nz, invs):
        x, y, _z = pts[i]
        zi2 = k.sqr(zi)
        out[i] = (k.mul(x, zi2), k.mul(y, k.mul(zi2, zi)))
    return out


def from_affine(k: FieldOps, aff):
    if aff is None:
        return inf(k)
    return (aff[0], aff[1], k.one)


def pt_neg(k: FieldOps, pt):
    return (pt[0], k.neg(pt[1]), pt[2])


def pt_double(k: FieldOps, pt):
    x, y, z = pt
    if k.is_zero(z):
        return pt
    a = k.sqr(x)                     # X²
    b = k.sqr(y)                     # Y²
    c = k.sqr(b)                     # Y⁴
    # D = 2((X+B)² - A - C)
    d = k.sub(k.sub(k.sqr(k.add(x, b)), a), c)
    d = k.add(d, d)
    e = k.add(k.add(a, a), a)        # 3X²  (curve a-coefficient is 0)
    f2_ = k.sqr(e)
    x3 = k.sub(f2_, k.add(d, d))
    c8 = k.add(k.add(c, c), k.add(c, c))
    c8 = k.add(c8, c8)
    y3 = k.sub(k.mul(e, k.sub(d, x3)), c8)
    z3 = k.mul(k.add(y, y), z)
    return (x3, y3, z3)


def pt_add(k: FieldOps, p1, p2):
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if k.is_zero(z1):
        return p2
    if k.is_zero(z2):
        return p1
    z1z1 = k.sqr(z1)
    z2z2 = k.sqr(z2)
    u1 = k.mul(x1, z2z2)
    u2 = k.mul(x2, z1z1)
    s1 = k.mul(y1, k.mul(z2z2, z2))
    s2 = k.mul(y2, k.mul(z1z1, z1))
    if u1 == u2:
        if s1 == s2:
            return pt_double(k, p1)
        return inf(k)
    h = k.sub(u2, u1)
    i = k.sqr(k.add(h, h))
    j = k.mul(h, i)
    r = k.sub(s2, s1)
    r = k.add(r, r)
    v = k.mul(u1, i)
    x3 = k.sub(k.sub(k.sqr(r), j), k.add(v, v))
    s1j = k.mul(s1, j)
    y3 = k.sub(k.mul(r, k.sub(v, x3)), k.add(s1j, s1j))
    z3 = k.mul(k.mul(z1, z2), h)
    z3 = k.add(z3, z3)
    # z3 = 2·z1·z2·h, consistent with the doubled r/i scaling above
    return (x3, y3, z3)


def pt_mul_binary(k: FieldOps, pt, n: int):
    """Scalar multiplication (binary double-and-add) — the reference ladder,
    kept as the differential oracle for the wNAF path."""
    if n < 0:
        return pt_mul_binary(k, pt_neg(k, pt), -n)
    result = inf(k)
    addend = pt
    while n:
        if n & 1:
            result = pt_add(k, result, addend)
        addend = pt_double(k, addend)
        n >>= 1
    return result


def _wnaf_digits(n: int, w: int) -> list:
    """Width-w non-adjacent form, LSB first: digits in ±{1,3,…,2^(w−1)−1}∪{0},
    no two adjacent nonzeros — bits/(w+1) additions on average vs bits/2."""
    digits = []
    while n:
        if n & 1:
            d = n & ((1 << w) - 1)
            if d >= 1 << (w - 1):
                d -= 1 << w
            n -= d
        else:
            d = 0
        digits.append(d)
        n >>= 1
    return digits


def pt_mul(k: FieldOps, pt, n: int):
    """Scalar multiplication via wNAF with a precomputed odd-multiples table
    (window 4 below ~130 bits, 5 above)."""
    if n < 0:
        return pt_mul(k, pt_neg(k, pt), -n)
    if n == 0 or k.is_zero(pt[2]):
        return inf(k)
    w = 4 if n.bit_length() < 130 else 5
    digits = _wnaf_digits(n, w)
    two_pt = pt_double(k, pt)
    tbl = [pt]  # tbl[i] = (2i+1)·pt
    for _ in range((1 << (w - 2)) - 1):
        tbl.append(pt_add(k, tbl[-1], two_pt))
    result = inf(k)
    for d in reversed(digits):
        result = pt_double(k, result)
        if d > 0:
            result = pt_add(k, result, tbl[(d - 1) >> 1])
        elif d < 0:
            result = pt_add(k, result, pt_neg(k, tbl[(-d - 1) >> 1]))
    return result


def pt_eq(k: FieldOps, p1, p2) -> bool:
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if k.is_zero(z1) or k.is_zero(z2):
        return k.is_zero(z1) and k.is_zero(z2)
    z1z1 = k.sqr(z1)
    z2z2 = k.sqr(z2)
    if k.mul(x1, z2z2) != k.mul(x2, z1z1):
        return False
    return k.mul(y1, k.mul(z2z2, z2)) == k.mul(y2, k.mul(z1z1, z1))


def is_on_curve_affine(k: FieldOps, aff, b) -> bool:
    if aff is None:
        return True
    x, y = aff
    return k.sqr(y) == k.add(k.mul(k.sqr(x), x), b)


# ---------------------------------------------------------------------------
# Group parameters
# ---------------------------------------------------------------------------

B1 = 4  # E1: y² = x³ + 4
B2 = F.f2_mul_xi((4, 0))  # E2: y² = x³ + 4(u+1)  == (4, 4)
B12 = FQ12.from_int(4)  # E over Fq12 (untwisted)

# Generators (standard BLS12-381 generators; verified in tests against
# on-curve + subgroup-order checks)
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
    F.F2_ONE,
)

# Cofactors: h1 = (x-1)²/3; h2 = (x⁸-4x⁷+5x⁶-4x⁴+6x³-4x²-4x+13)/9
H1 = (X - 1) ** 2 // 3
H2 = (X**8 - 4 * X**7 + 5 * X**6 - 4 * X**4 + 6 * X**3 - 4 * X**2 - 4 * X + 13) // 9
assert H1 == 0x396C8C005555E1568C00AAAB0000AAAB
# RFC 9380 §8.8.2 effective G2 cofactor (Budroni–Pintore): h_eff = 3(z²−1)·h2
# with z = -X. Using h_eff (not h2) in hash-to-curve is REQUIRED for wire
# compatibility — [h_eff]Q = [3(z²−1) mod r]·[h2]Q, a different G2 point.
H2_EFF = 3 * (X * X - 1) * H2

# ---------------------------------------------------------------------------
# Fixed-base scalar multiplication for the G1 generator
# ---------------------------------------------------------------------------
# Every `public_key()` is a G1_GEN multiple; a one-time 4-bit window table
# (tbl[i][d-1] = d·2^(4i)·G, 64 chunks × 15 digits) turns the 256-bit ladder
# into ≤64 additions with no doublings. Built lazily on first use.

_GEN_TBL: list | None = None


def _build_gen_table() -> list:
    tbl = []
    base = G1_GEN
    for _ in range(64):
        row = [base]
        for _ in range(14):
            row.append(pt_add(FQ, row[-1], base))
        tbl.append(row)
        for _ in range(4):
            base = pt_double(FQ, base)
    return tbl


def g1_gen_mul(n: int):
    """[n]·G1_GEN via the fixed-base window table."""
    global _GEN_TBL
    if _GEN_TBL is None:
        _GEN_TBL = _build_gen_table()
    n %= R
    acc = inf(FQ)
    i = 0
    while n:
        d = n & 15
        if d:
            acc = pt_add(FQ, acc, _GEN_TBL[i][d - 1])
        n >>= 4
        i += 1
    return acc


# ---------------------------------------------------------------------------
# Subgroup / membership checks
# ---------------------------------------------------------------------------

# ψ = untwist ∘ Frobenius ∘ twist, on twisted coordinates:
# ψ(x, y) = (cx·x̄, cy·ȳ) with cx = ξ^(−(p−1)/3), cy = ξ^(−(p−1)/2).
# On G2 it acts as multiplication by x (p ≡ x mod r) — the basis of both the
# fast membership test and Budroni–Pintore cofactor clearing; the same
# criterion the card's kernels use (csrc/bls381_field.cuh g2_in_subgroup).
_PSI_CX = F.f2_pow(F.f2_inv(F.XI), (P - 1) // 3)
_PSI_CY = F.f2_pow(F.f2_inv(F.XI), (P - 1) // 2)

assert P % R == X % R  # ψ acts as [x] on G2


def g2_psi(pt):
    """ψ on Jacobian twisted coordinates (conjugate-linear, so Z̄ carries the
    coordinate weights through)."""
    x, y, z = pt
    return (
        F.f2_mul(F.f2_conj(x), _PSI_CX),
        F.f2_mul(F.f2_conj(y), _PSI_CY),
        F.f2_conj(z),
    )


def g1_is_on_curve(pt) -> bool:
    return is_on_curve_affine(FQ, to_affine(FQ, pt), B1)


def g2_is_on_curve(pt) -> bool:
    return is_on_curve_affine(FQ2, to_affine(FQ2, pt), B2)


def g1_in_subgroup(pt) -> bool:
    return g1_is_on_curve(pt) and is_inf(FQ, pt_mul(FQ, pt, R))


def g2_in_subgroup(pt) -> bool:
    """ψ(Q) == [x]Q membership test: a 64-bit ladder instead of the 255-bit
    order multiplication (differentially tested against it)."""
    if not g2_is_on_curve(pt):
        return False
    if is_inf(FQ2, pt):
        return True
    # x < 0: ψ(Q) − [x]Q = ψ(Q) + [|x|]Q
    s = pt_add(FQ2, g2_psi(pt), pt_mul(FQ2, pt, -X))
    return is_inf(FQ2, s)


# ---------------------------------------------------------------------------
# ZCash-format point serialization
# (flags in the 3 top bits of the first byte: compressed, infinity, y-sign)
# ---------------------------------------------------------------------------

_COMPRESSED = 1 << 7
_INFINITY = 1 << 6
_Y_SIGN = 1 << 5


def _fq_to_bytes(v: int) -> bytes:
    return v.to_bytes(48, "big")


def _y_is_large(y: int) -> bool:
    return y > (P - 1) // 2


def g1_to_bytes(pt) -> bytes:
    aff = to_affine(FQ, pt)
    if aff is None:
        out = bytearray(48)
        out[0] = _COMPRESSED | _INFINITY
        return bytes(out)
    x, y = aff
    out = bytearray(_fq_to_bytes(x))
    out[0] |= _COMPRESSED
    if _y_is_large(y):
        out[0] |= _Y_SIGN
    return bytes(out)


def g1_from_bytes(data: bytes):
    """Decompress 48-byte G1 point. Raises ValueError on malformed input.
    Subgroup membership is NOT checked here (callers decide, mirroring the
    reference's deserialize/validate split)."""
    if len(data) != 48:
        raise ValueError(f"G1 compressed point must be 48 bytes, got {len(data)}")
    flags = data[0]
    if not flags & _COMPRESSED:
        raise ValueError("uncompressed G1 deserialization not supported")
    if flags & _INFINITY:
        if any(data[1:]) or flags & ~(_COMPRESSED | _INFINITY):
            raise ValueError("malformed G1 infinity encoding")
        return inf(FQ)
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("G1 x coordinate >= field modulus")
    rhs = (x * x % P * x + B1) % P
    y = pow(rhs, (P + 1) // 4, P)
    if y * y % P != rhs:
        raise ValueError("G1 point not on curve")
    if bool(flags & _Y_SIGN) != _y_is_large(y):
        y = (-y) % P
    return (x, y, 1)


def g2_to_bytes(pt) -> bytes:
    return g2_affine_to_bytes(to_affine(FQ2, pt))


def g2_affine_to_bytes(aff) -> bytes:
    """Compress an affine G2 point ((x, y) or None for infinity) — the
    serialization half of `g2_to_bytes`, split out so batch signers can
    normalize many points with one `batch_to_affine` inversion first."""
    if aff is None:
        out = bytearray(96)
        out[0] = _COMPRESSED | _INFINITY
        return bytes(out)
    (x0, x1), (y0, y1) = aff
    out = bytearray(_fq_to_bytes(x1) + _fq_to_bytes(x0))
    out[0] |= _COMPRESSED
    if y1 > (P - 1) // 2 or (y1 == 0 and y0 > (P - 1) // 2):
        out[0] |= _Y_SIGN
    return bytes(out)


def g2_from_bytes(data: bytes):
    """Decompress 96-byte G2 point (x_c1 first, per ZCash convention)."""
    if len(data) != 96:
        raise ValueError(f"G2 compressed point must be 96 bytes, got {len(data)}")
    flags = data[0]
    if not flags & _COMPRESSED:
        raise ValueError("uncompressed G2 deserialization not supported")
    if flags & _INFINITY:
        if any(data[1:]) or flags & ~(_COMPRESSED | _INFINITY):
            raise ValueError("malformed G2 infinity encoding")
        return inf(FQ2)
    x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x coordinate >= field modulus")
    x = (x0, x1)
    rhs = F.f2_add(F.f2_mul(F.f2_sqr(x), x), B2)
    y = F.f2_sqrt(rhs)
    if y is None:
        raise ValueError("G2 point not on curve")
    y_large = y[1] > (P - 1) // 2 or (y[1] == 0 and y[0] > (P - 1) // 2)
    if bool(flags & _Y_SIGN) != y_large:
        y = F.f2_neg(y)
    return (x, y, F.F2_ONE)


def g2_clear_cofactor(pt):
    """Map a point on E2 into the r-order subgroup G2.

    Computes [h_eff]Q for the RFC 9380 effective cofactor h_eff = 3(z²−1)·h2
    (what BLS12381G2_XMD:SHA-256_SSWU_RO_ and hence blst use — NOT the plain
    cofactor h2), via the Budroni–Pintore endomorphism form

        [h_eff]Q = [x²−x−1]Q + [x−1]ψ(Q) + ψ²(2Q)

    — two |x|-ladders and three ψ instead of a 636-bit multiplication. The
    identity is differentially tested against pt_mul(·, H2_EFF), and the
    card's kernels (csrc/bls381_field.cuh g2_clear_cofactor) use the same
    form.
    """
    a = pt_neg(FQ2, pt_mul(FQ2, pt, -X))  # [x]Q
    neg_q = pt_neg(FQ2, pt)
    c1 = pt_add(FQ2, a, neg_q)  # [x−1]Q
    c2 = pt_neg(FQ2, pt_mul(FQ2, c1, -X))  # [x²−x]Q
    c3 = pt_add(FQ2, c2, neg_q)  # [x²−x−1]Q
    out = pt_add(FQ2, c3, g2_psi(c1))
    return pt_add(FQ2, out, g2_psi(g2_psi(pt_double(FQ2, pt))))


def g1_clear_cofactor(pt):
    return pt_mul(FQ, pt, H1)
