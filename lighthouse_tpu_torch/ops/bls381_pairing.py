"""The BLS12-381 multi-pairing check and G2 subgroup check (K4).

Counterpart of lighthouse_tpu/ops/bls381_pairing.py. Its kernels,
``csrc/bls381_pairing.cu``, replace ``g2_subgroup_check_device`` (:418)
and ``multi_pairing_check_device`` (:340, with ``miller_loop_batch`` :211,
``_mask_and_reduce`` :325 and ``final_exp_cubed`` :305);
``g2_clear_cofactor_device`` (:440) is device code run inside the
hash-to-G2 kernel (ops/bls381_htc.py), and its plain version is here.
The multi-pairing runs a warp per pair on Fq12 team rounds; the subgroup
check a warp per point on the G2 team steps of ``csrc/g2_team.cuh``.

The GT convention: the final exponentiation is the standard one,
f^((p^12 - 1)/r), equal to the host oracle's ``pairing`` value (the JAX
kernel returns its cube; both agree on every ``== 1`` check, since
gcd(3, r) = 1). The Miller loop is the host oracle's
(crypto/bls12_381/pairing.py): projective on the twist with sparse lines,
so even its Fq12 output equals the oracle's ``miller_loop``.

Layout: G1 affine [..., 2, 12], G2 affine [..., 2, 2, 12], Fq12
[..., 2, 3, 2, 12], infinity masks bool. A CUDA tensor goes to the kernel,
a CPU tensor to the plain version (``*_plain``).
"""

from __future__ import annotations

import torch

from ..crypto.bls12_381 import curve as HC
from ..crypto.bls12_381.curve import B2
from ..crypto.bls12_381.fields import P as _P
from ..crypto.bls12_381.fields import R as _R
from ..crypto.bls12_381.fields import X
from .bls381 import (
    NLIMB,
    check_limbs,
    fq_const16,
    is_zero16,
    pack32,
    pt_add,
    pt_double,
    pt_neg,
    to16,
    to32,
    unpack16,
    where16,
)
from .bls381_tower import (
    Fq2,
    f2_conj16,
    f2_mul16,
    f2_mul_fq16,
    f2_mul_xi16,
    f2_sqr16,
    f12_conj16,
    f12_cyclotomic_pow16,
    f12_frob16,
    f12_inv16,
    f12_is_one16,
    f12_mul16,
    f12_mul_by_045_16,
    f12_one16,
    f12_sqr16,
    fq2_const16,
)
from .cuda_build import CudaLibrary

_X_ABS = -X
_M1 = (1 - X) // 3  # |(x - 1)/3|, integral for BLS12-381
_M2 = 1 - X

COUNTS = {"g2_subgroup_check": 0, "multi_pairing": 0}

LIB = CudaLibrary(
    "bls381_pairing.cu",
    {
        "bls_g2_subgroup_check": ("p", "p", "p", "i64", "p"),
        "bls_multi_pairing": ("p", "p", "p", "p", "p", "p", "i32", "p"),
    },
)


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


# ---------------------------------------------------------------------------
# Miller loop and final exponentiation (plain; pairing.py's formulas)
# ---------------------------------------------------------------------------


def _half(a):
    return f2_mul_fq16(a, fq_const16((_P + 1) // 2, a.device))


def _dbl_step(T, xp, yp):
    X_, Y, Z = T
    a = _half(f2_mul16(X_, Y))
    b = f2_sqr16(Y)
    c = f2_sqr16(Z)
    e = f2_mul16(fq2_const16(B2, X_.device), Fq2.add(Fq2.add(c, c), c))
    f3 = Fq2.add(Fq2.add(e, e), e)
    g = _half(Fq2.add(b, f3))
    h = Fq2.sub(f2_sqr16(Fq2.add(Y, Z)), Fq2.add(b, c))
    i = Fq2.sub(e, b)
    j = f2_sqr16(X_)
    e2 = f2_sqr16(e)
    x3 = f2_mul16(a, Fq2.sub(b, f3))
    y3 = Fq2.sub(f2_sqr16(g), Fq2.add(Fq2.add(e2, e2), e2))
    z3 = f2_mul16(b, h)
    c0 = f2_mul_xi16(f2_mul_fq16(Fq2.neg(h), yp))
    c5 = f2_mul_fq16(Fq2.add(Fq2.add(j, j), j), xp)
    return (x3, y3, z3), (c0, i, c5)


def _add_step(T, xq, yq, xp, yp):
    X_, Y, Z = T
    theta = Fq2.sub(Y, f2_mul16(yq, Z))
    lam = Fq2.sub(X_, f2_mul16(xq, Z))
    cc = f2_sqr16(theta)
    dd = f2_sqr16(lam)
    ee = f2_mul16(lam, dd)
    ff = f2_mul16(Z, cc)
    gg = f2_mul16(X_, dd)
    hh = Fq2.add(Fq2.sub(ee, Fq2.add(gg, gg)), ff)
    x3 = f2_mul16(lam, hh)
    y3 = Fq2.sub(f2_mul16(theta, Fq2.sub(gg, hh)), f2_mul16(ee, Y))
    z3 = f2_mul16(Z, ee)
    jj = Fq2.sub(f2_mul16(theta, xq), f2_mul16(lam, yq))
    c0 = f2_mul_xi16(f2_mul_fq16(Fq2.neg(lam), yp))
    return (x3, y3, z3), (c0, Fq2.neg(jj), f2_mul_fq16(theta, xp))


def miller_loop16(xq, yq, xp, yp):
    """f_{|x|,Q}(P), conjugated for x < 0, per lane (16-bit limbs)."""
    T = (xq, yq, Fq2.one(xq.device).expand_as(xq))
    f = f12_one16(xp.shape[:-1], xp.device)
    for bit in bin(_X_ABS)[3:]:
        f = f12_sqr16(f)
        T, line = _dbl_step(T, xp, yp)
        f = f12_mul_by_045_16(f, *line)
        if bit == "1":
            T, line = _add_step(T, xq, yq, xp, yp)
            f = f12_mul_by_045_16(f, *line)
    return f12_conj16(f)


def final_exponentiation16(f):
    """f^((p^12 - 1)/r), exact (pairing.py final_exponentiation)."""
    t = f12_mul16(f12_conj16(f), f12_inv16(f))
    t = f12_mul16(f12_frob16(f12_frob16(t)), t)
    y = f12_conj16(f12_cyclotomic_pow16(t, _M1))
    y = f12_conj16(f12_cyclotomic_pow16(y, _M2))
    y = f12_mul16(f12_conj16(f12_cyclotomic_pow16(y, _X_ABS)), f12_frob16(y))
    y2 = f12_cyclotomic_pow16(f12_cyclotomic_pow16(y, _X_ABS), _X_ABS)
    y = f12_mul16(f12_mul16(y2, f12_frob16(f12_frob16(y))), f12_conj16(y))
    return f12_mul16(y, t)


def _product16(f):
    """Product over axis 0 of [m, ...] Fq12 values (a tree; the value is
    the same in any order)."""
    while f.shape[0] > 1:
        if f.shape[0] % 2:
            f = torch.cat((f, f12_one16((1,), f.device)), 0)
        f = f12_mul16(f[0::2], f[1::2])
    return f[0]


def _unpack_affine(p, q):
    xp, yp = (to16(c) for c in p.unbind(-2))
    xq, yq = (to16(c) for c in q.unbind(-3))
    return xq, yq, xp, yp


def multi_pairing_plain(p, p_inf, q, q_inf):
    """final_exponentiation(prod over pairs with neither point at infinity
    of miller_loop(Q_i, P_i)) -> [2, 3, 2, 12]."""
    xq, yq, xp, yp = _unpack_affine(p, q)
    f = miller_loop16(xq, yq, xp, yp)
    skip = p_inf | q_inf
    f = where16(skip, f12_one16(skip.shape, f.device), f, 4)
    return to32(final_exponentiation16(_product16(f)))


def pairing_plain(p, q):
    """e(P_i, Q_i) per lane -> [n, 2, 3, 2, 12] (tests; the verifier only
    needs the product's check)."""
    xq, yq, xp, yp = _unpack_affine(p, q)
    return to32(final_exponentiation16(miller_loop16(xq, yq, xp, yp)))


def miller_loop_plain(p, q):
    xq, yq, xp, yp = _unpack_affine(p, q)
    return to32(miller_loop16(xq, yq, xp, yp))


# ---------------------------------------------------------------------------
# psi, the |x| ladder, subgroup check, cofactor clearing (plain)
# ---------------------------------------------------------------------------


def psi16(T):
    X_, Y, Z = T
    dev = X_.device
    return (
        f2_mul16(f2_conj16(X_), fq2_const16(HC._PSI_CX, dev)),
        f2_mul16(f2_conj16(Y), fq2_const16(HC._PSI_CY, dev)),
        f2_conj16(Z),
    )


def pt_mul_x_abs16(F, T):
    """[|x|]T, left to right from T over the bits below the top one."""
    acc = T
    for bit in bin(_X_ABS)[3:]:
        acc = pt_double(F, acc)
        if bit == "1":
            acc = pt_add(F, acc, T)
    return acc


def g2_in_subgroup16(xq, yq):
    one = Fq2.one(xq.device).expand_as(xq)
    q = (xq, yq, one)
    s = pt_add(Fq2, psi16(q), pt_mul_x_abs16(Fq2, q))
    return is_zero16(s[2], 2)


def g2_subgroup_check_plain(q, q_inf):
    xq, yq = (to16(c) for c in q.unbind(-3))
    return g2_in_subgroup16(xq, yq) | q_inf


def g2_clear_cofactor16(q):
    """[h_eff]Q = [x^2 - x - 1]Q + [x - 1]psi(Q) + psi^2(2Q)."""
    a = pt_neg(Fq2, pt_mul_x_abs16(Fq2, q))
    nq = pt_neg(Fq2, q)
    c1 = pt_add(Fq2, a, nq)
    c2 = pt_neg(Fq2, pt_mul_x_abs16(Fq2, c1))
    c2 = pt_add(Fq2, c2, nq)
    c2 = pt_add(Fq2, c2, psi16(c1))
    return pt_add(Fq2, c2, psi16(psi16(pt_double(Fq2, q))))


def g2_clear_cofactor_plain(pts):
    """[n, 3, 2, 12] Jacobian -> [n, 3, 2, 12] in the r-torsion subgroup."""
    check_limbs(pts, (3, 2, NLIMB), "pts")
    return pack32(g2_clear_cofactor16(unpack16(pts, 2)), 2)


# ---------------------------------------------------------------------------
# Wrappers: the kernel on a CUDA tensor, the plain version on a CPU tensor
# ---------------------------------------------------------------------------


def _mask(m: torch.Tensor, n: int, name: str) -> torch.Tensor:
    if m.dtype != torch.bool or m.shape != (n,):
        raise ValueError(f"{name}: expected [{n}] bool, got {list(m.shape)} {m.dtype}")
    return m.contiguous()


def g2_subgroup_check(q: torch.Tensor, q_inf: torch.Tensor) -> torch.Tensor:
    """psi(Q) == [x]Q per point: q [n, 2, 2, 12] affine, q_inf [n] bool ->
    [n] bool (an infinity counts as a member)."""
    check_limbs(q, (2, 2, NLIMB), "q")
    n = q.shape[0]
    q_inf = _mask(q_inf, n, "q_inf")
    if q.device.type == "cpu":
        return g2_subgroup_check_plain(q, q_inf)
    if q_inf.device != q.device:
        raise ValueError("q and q_inf on different devices")
    ok = torch.empty(n, dtype=torch.bool, device=q.device)
    if n:
        LIB.launch("bls_g2_subgroup_check", q.data_ptr(), q_inf.data_ptr(), ok.data_ptr(), n, device=q.device)
        COUNTS["g2_subgroup_check"] += 1
    return ok


def multi_pairing(p, p_inf, q, q_inf) -> torch.Tensor:
    """prod_i e(P_i, Q_i) over the pairs with neither point at infinity:
    p [m, 2, 12], q [m, 2, 2, 12] affine, masks [m] bool -> [2, 3, 2, 12]."""
    check_limbs(p, (2, NLIMB), "p")
    check_limbs(q, (2, 2, NLIMB), "q")
    m = p.shape[0]
    if q.shape[0] != m:
        raise ValueError(f"{m} G1 points, {q.shape[0]} G2 points")
    p_inf = _mask(p_inf, m, "p_inf")
    q_inf = _mask(q_inf, m, "q_inf")
    if p.device.type == "cpu":
        return multi_pairing_plain(p, p_inf, q, q_inf)
    dev = p.device
    if any(t.device != dev for t in (p_inf, q, q_inf)):
        raise ValueError("pairing inputs on different devices")
    out = torch.empty((2, 3, 2, NLIMB), dtype=torch.int64, device=dev)
    scratch = torch.empty((max(m, 1), 2, 3, 2, NLIMB), dtype=torch.int64, device=dev)
    LIB.launch(
        "bls_multi_pairing", p.data_ptr(), p_inf.data_ptr(), q.data_ptr(), q_inf.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), m, device=dev,
    )
    COUNTS["multi_pairing"] += 1
    return out


def f12_is_one(f: torch.Tensor) -> torch.Tensor:
    return f12_is_one16(to16(f))


def multi_pairing_check(p, p_inf, q, q_inf) -> bool:
    """prod e(P_i, Q_i) == 1."""
    return bool(f12_is_one(multi_pairing(p, p_inf, q, q_inf)))


assert (_P % _R) == (X % _R)  # psi acts as [x] on G2: the subgroup criterion
