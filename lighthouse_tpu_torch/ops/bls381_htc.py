"""RFC 9380 hash-to-G2 from field elements (K5).

Counterpart of lighthouse_tpu/ops/bls381_htc.py. Its kernel,
``csrc/bls381_htc.cu``, replaces ``hash_to_g2_device`` (:311): two
simplified-SWU maps (``map_to_curve_sswu_device`` :267, with the Fq2
square root ``f2_sqrt_device`` :169 and ``f2_sgn0_device`` :215), the
3-isogeny (``isogeny_to_e2_device`` :295), the pair add and the cofactor
clearing of bls381_pairing.py:440, a warp per message. The host keeps
``expand_message_xmd`` (``messages_to_field``, as the JAX package's
``messages_to_field_device`` :329 does).

The kernel never inverts: the maps keep x as x_num / x_den and take the
root of gx1 = U / V by the complex method on U conj(V) and norm(V), the
two points are added on E' in Jacobian form and the isogeny maps the sum
in projective form (csrc/bls381_htc.cu's header). The plain version
computes the same representatives step for step, every per-message
branch as a select, so the two agree limb for limb; the affine point is
the host oracle's (crypto/bls12_381/hash_to_curve.py).

Layout: u [m, 2, 2, 12] (per message the two hash_to_field outputs u0,
u1, Montgomery Fq2), output [m, 3, 2, 12] Jacobian G2. A CUDA tensor goes
to the kernel, a CPU tensor to the plain version ``hash_to_g2_plain``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.bls12_381 import hash_to_curve as HH
from ..crypto.bls12_381.fields import P
from .bls381 import (
    NLIMB,
    R_MONT,
    check_limbs,
    eq16,
    fq_add16,
    fq_const16,
    fq_mul16,
    fq_neg16,
    fq_pow16,
    fq_sub16,
    is_zero16,
    pack32,
    pt_add,
    to16,
    where16,
)
from .bls381_pairing import g2_clear_cofactor16
from .bls381_tower import Fq2, f2_conj16, f2_mul16, f2_sqr16, fq2_const16
from .cuda_build import CudaLibrary

COUNTS = {"hash_to_g2": 0}

LIB = CudaLibrary("bls381_htc.cu", {"bls_hash_to_g2": ("p", "p", "i64", "p")})

# sqrt(-5): n^2 = -N(W) where W is not a square, and norm(Z) = 5
_SQRT_M5 = pow(-5 % P, (P + 1) // 4, P)


def reset_counts() -> None:
    COUNTS["hash_to_g2"] = 0


def _k(name: str, dev) -> torch.Tensor:
    return fq2_const16(getattr(HH, name), dev)


# ---------------------------------------------------------------------------
# Host stage
# ---------------------------------------------------------------------------


def messages_to_field(messages, dst: bytes = HH.DST_G2_POP) -> np.ndarray:
    """expand_message_xmd + mod-p reduction on the host -> [m, 2, 2, 12]
    Montgomery limbs (u0, u1 per message)."""
    vals = []
    for msg in messages:
        for u in HH.hash_to_field_fq2(msg, 2, dst):
            vals.extend(u)
    buf = b"".join((v * R_MONT % P).to_bytes(48, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").astype(np.int64).reshape(-1, 2, 2, NLIMB)


# ---------------------------------------------------------------------------
# The plain version (16-bit limbs)
# ---------------------------------------------------------------------------


def _halve(a):
    """a / 2 mod p (the kernel's fq_halve)."""
    return fq_mul16(a, fq_const16((P + 1) // 2, a.device))


def _norm(a):
    sq = fq_mul16(a, a)
    return fq_add16(sq[..., 0, :], sq[..., 1, :])


def _sgn0(a):
    one = torch.zeros_like(a[..., 0, :])
    one[..., 0] = 1
    c = fq_mul16(a, one.unsqueeze(-2))  # out of Montgomery form
    c0, c1 = c[..., 0, :], c[..., 1, :]
    return (c0[..., 0] & 1) | (is_zero16(c0).to(torch.int64) & (c1[..., 0] & 1))


def map_to_curve_sswu16(u):
    """The simplified SWU map onto E' (RFC 9380 6.6.2) without inversion,
    as the kernel computes it: x = x_num / x_den, the root of gx1 = U / V by
    the complex method on W = U conj(V), M = norm(V) with two Fq powers (or
    the root of Z gx1 where gx1 is not a square), the sign by sgn0. Returns
    the Jacobian point (x_num x_den, y x_den^3, x_den), each [n, 2, 24]."""
    dev = u.device
    a_, b_, z_ = _k("_A", dev), _k("_B", dev), _k("_Z", dev)
    tv1 = f2_mul16(z_, f2_sqr16(u))
    tv2 = fq_add16(f2_sqr16(tv1), tv1)
    tv3 = f2_mul16(b_, fq_add16(tv2, Fq2.one(dev).expand_as(u)))  # x_num
    tv4 = f2_mul16(a_, where16(is_zero16(tv2, 2), z_.expand_as(u), fq_neg16(tv2), 2))  # x_den
    tv6 = f2_sqr16(tv4)
    un = f2_mul16(fq_add16(f2_sqr16(tv3), f2_mul16(a_, tv6)), tv3)
    v = f2_mul16(tv6, tv4)
    un = fq_add16(un, f2_mul16(b_, v))
    w = f2_mul16(un, f2_conj16(v))
    m, nw = _norm(v), _norm(w)
    n = fq_pow16(nw, (P + 1) // 4)
    is_sq = eq16(fq_mul16(n, n), nw)
    w = where16(is_sq, w, f2_mul16(z_, w), 2)
    n = where16(is_sq, n, fq_mul16(fq_const16(_SQRT_M5, dev), n))
    w0, w1 = w[..., 0, :], w[..., 1, :]
    delta = _halve(fq_add16(w0, n))
    delta = where16(is_zero16(delta), _halve(fq_sub16(w0, n)), delta)
    h = fq_mul16(delta, m)
    g = fq_pow16(h, (P - 3) // 4)
    delta_sq = eq16(fq_mul16(fq_mul16(g, g), h), fq_const16(1, dev).expand_as(h))
    tt, cc = fq_mul16(delta, g), _halve(fq_mul16(w1, g))
    y1 = where16(delta_sq, torch.stack((tt, cc), -2), torch.stack((cc, fq_neg16(tt)), -2), 2)
    y = where16(is_sq, y1, f2_mul16(f2_mul16(tv1, u), y1), 2)
    xn = where16(is_sq, tv3, f2_mul16(tv1, tv3), 2)
    y = where16(_sgn0(u) != _sgn0(y), fq_neg16(y), y, 2)
    return f2_mul16(xn, tv4), f2_mul16(y, v), tv4


def _pt_double_e1(p):
    """2P on E' (a = 240u): curve.py's pt_double with E = 3 X^2 + a Z^4."""
    x, y, z = p
    a, b = f2_sqr16(x), f2_sqr16(y)
    c = f2_sqr16(b)
    d = fq_sub16(fq_sub16(f2_sqr16(fq_add16(x, b)), a), c)
    d = fq_add16(d, d)
    e = fq_add16(fq_add16(fq_add16(a, a), a), f2_mul16(_k("_A", x.device), f2_sqr16(f2_sqr16(z))))
    x3 = fq_sub16(f2_sqr16(e), fq_add16(d, d))
    c8 = fq_add16(c, c)
    c8 = fq_add16(c8, c8)
    c8 = fq_add16(c8, c8)
    yz = f2_mul16(y, z)
    return x3, fq_sub16(f2_mul16(e, fq_sub16(d, x3)), c8), fq_add16(yz, yz)


def _pt_add_e1(p, q):
    """P + Q on E': pt_add's cases, P == Q by the general-a doubling."""
    out = pt_add(Fq2, p, q)
    z1z1, z2z2 = f2_sqr16(p[2]), f2_sqr16(q[2])
    same = (
        ~is_zero16(p[2], 2)
        & ~is_zero16(q[2], 2)
        & eq16(f2_mul16(p[0], z2z2), f2_mul16(q[0], z1z1), 2)
        & eq16(f2_mul16(p[1], f2_mul16(z2z2, q[2])), f2_mul16(q[1], f2_mul16(z1z1, p[2])), 2)
    )
    if bool(same.any()):
        out = tuple(where16(same, a, b, 2) for a, b in zip(_pt_double_e1(p), out))
    return out


def isogeny_to_e2_16(x, y, z):
    """The 3-isogeny E' -> E2 on a Jacobian point, in projective form (the
    host oracle's Velu map with d = x' - x0, 1/9 and 1/27 folded into Z):
    X = X' D^2 + T D Z'^4 + U Z'^6, Y = -Y' (D^3 - T D Z'^4 - 2 U Z'^6),
    Z = 3 D Z' with D = X' - x0 Z'^2."""
    dev = x.device
    zz = f2_sqr16(z)
    z4 = f2_sqr16(zz)
    z6 = f2_mul16(z4, zz)
    d = fq_sub16(x, f2_mul16(_k("_X0", dev), zz))
    d2 = f2_sqr16(d)
    tdz4 = f2_mul16(_k("_T", dev), f2_mul16(d, z4))
    uz6 = f2_mul16(_k("_U", dev), z6)
    px = fq_add16(fq_add16(f2_mul16(x, d2), tdz4), uz6)
    inner = fq_sub16(fq_sub16(fq_sub16(f2_mul16(d2, d), tdz4), uz6), uz6)
    dz = f2_mul16(d, z)
    return px, fq_neg16(f2_mul16(y, inner)), fq_add16(fq_add16(dz, dz), dz)


def hash_to_g2_16(u):
    """u [m, 2, 2, 24] -> Jacobian G2 (x, y, z), each [m, 2, 24]."""
    m = u.shape[0]
    flat = torch.cat((u[:, 0], u[:, 1]), 0)  # u0 maps, then u1 maps
    x, y, z = map_to_curve_sswu16(flat)
    s = _pt_add_e1((x[:m], y[:m], z[:m]), (x[m:], y[m:], z[m:]))
    return g2_clear_cofactor16(isogeny_to_e2_16(*s))


def hash_to_g2_plain(u: torch.Tensor) -> torch.Tensor:
    return pack32(hash_to_g2_16(to16(u)), 2)


# ---------------------------------------------------------------------------
# Wrapper: the kernel on a CUDA tensor, the plain version on a CPU tensor
# ---------------------------------------------------------------------------


def hash_to_g2(u: torch.Tensor) -> torch.Tensor:
    """u [m, 2, 2, 12] field elements -> [m, 3, 2, 12] Jacobian G2 points in
    the r-torsion subgroup."""
    check_limbs(u, (2, 2, NLIMB), "u")
    if u.device.type == "cpu":
        return hash_to_g2_plain(u)
    if u.device.type != "cuda":
        raise ValueError(f"u on {u.device}: need a CUDA device")
    m = u.shape[0]
    out = torch.empty((m, 3, 2, NLIMB), dtype=torch.int64, device=u.device)
    if m:
        LIB.launch("bls_hash_to_g2", u.data_ptr(), out.data_ptr(), m, device=u.device)
        COUNTS["hash_to_g2"] += 1
    return out

