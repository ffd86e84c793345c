"""Fq2 / Fq6 / Fq12 tower arithmetic for the BLS12-381 pairing (K3).

Counterpart of lighthouse_tpu/ops/bls381_tower.py (``f2_*``/``f6_*``/
``f12_*``, :77-347, ``fq_inv`` :140). On the card the tower has no kernel
of its own: it is ``__device__`` code in ``csrc/bls381_field.cuh``,
compiled into the pairing (K4) and hash-to-G2 (K5) kernels. This module is
its plain PyTorch version, used by those kernels' plain versions and the
CPU tests.

Layouts (all Montgomery, R = 2^384): Fq2 [..., 2, limbs] (c0 + c1 u,
u^2 = -1), Fq6 [..., 3, 2, limbs] (v^3 = xi = 1 + u), Fq12
[..., 2, 3, 2, limbs] (w^2 = v). The ``*16`` functions take 24 16-bit
limbs (``ops.bls381.to16``); the public ones take the port's 12 32-bit
limbs. The formulas are the host oracle's (crypto/bls12_381/fields.py);
independent products are stacked into one Montgomery multiplication, so an
Fq12 product is one batched call of 54 Fq products.
"""

from __future__ import annotations

import functools

import torch

from ..crypto.bls12_381 import fields as HF
from ..crypto.bls12_381.fields import P
from .bls381 import (
    R_MONT,
    consts,
    fq_add16,
    fq_const16,
    fq_inv16,
    fq_mul16,
    fq_neg16,
    fq_sub16,
    to16,
    to32,
)


@functools.cache
def fq2_const16(c, dev) -> torch.Tensor:
    """A host Fq2 pair as [2, 24] Montgomery limbs on `dev` (made once;
    callers must not write to it)."""
    return torch.stack([fq_const16(c[0], dev), fq_const16(c[1], dev)])


# ---------------------------------------------------------------------------
# Fq2 ([..., 2, 24])
# ---------------------------------------------------------------------------


def _pair(a):
    return a[..., 0, :], a[..., 1, :]


def f2_mul16(a, b):
    """Karatsuba: the three products in one call."""
    a0, a1 = _pair(a)
    b0, b1 = _pair(b)
    t0, t1, x = fq_mul16(
        torch.stack(torch.broadcast_tensors(a0, a1, a0 + a1), -2),
        torch.stack(torch.broadcast_tensors(b0, b1, b0 + b1), -2),
    ).unbind(-2)
    lhs, rhs = torch.broadcast_tensors(torch.stack((t0, x), -2), torch.stack((t1, fq_add16(t0, t1)), -2))
    return fq_sub16(lhs, rhs)


def f2_sqr16(a):
    """(a0 + a1)(a0 - a1), 2 a0 a1."""
    a0, a1 = _pair(a)
    c0, t = fq_mul16(torch.stack((a0 + a1, a0), -2), torch.stack((fq_sub16(a0, a1), a1), -2)).unbind(-2)
    return torch.stack((c0, fq_add16(t, t)), -2)


def f2_mul_xi16(a):
    a0, a1 = _pair(a)
    return torch.stack((fq_sub16(a0, a1), fq_add16(a0, a1)), -2)


def f2_conj16(a):
    a0, a1 = _pair(a)
    return torch.stack((a0, fq_neg16(a1)), -2)


def f2_mul_fq16(a, s):
    return fq_mul16(a, s.unsqueeze(-2))


def f2_inv16(a):
    a0, a1 = _pair(a)
    sq = fq_mul16(a, a)
    ninv = fq_inv16(fq_add16(sq[..., 0, :], sq[..., 1, :]))
    c = fq_mul16(a, ninv.unsqueeze(-2))
    return torch.stack((c[..., 0, :], fq_neg16(c[..., 1, :])), -2)


class Fq2:
    """Fq2 for the generic point code of ops.bls381."""

    dims = 2
    mul = staticmethod(f2_mul16)
    sqr = staticmethod(f2_sqr16)
    add = staticmethod(fq_add16)
    sub = staticmethod(fq_sub16)
    neg = staticmethod(fq_neg16)
    inv = staticmethod(f2_inv16)

    @staticmethod
    def one(dev):
        return fq2_const16(HF.F2_ONE, dev)


# ---------------------------------------------------------------------------
# Fq6 ([..., 3, 2, 24])
# ---------------------------------------------------------------------------


def f6_mul_by_v16(a):
    a0, a1, a2 = a.unbind(-3)
    return torch.stack((f2_mul_xi16(a2), a0, a1), -3)


def f6_mul16(a, b):
    """Six Fq2 products in one call (fields.py f6_mul)."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a.unbind(-3)
    b0, b1, b2 = b.unbind(-3)
    sa = fq_add16(torch.stack((a1, a0, a0), -3), torch.stack((a2, a1, a2), -3))
    sb = fq_add16(torch.stack((b1, b0, b0), -3), torch.stack((b2, b1, b2), -3))
    t = f2_mul16(torch.cat((a, sa), -3), torch.cat((b, sb), -3))
    t0, t1, t2, x12, x01, x02 = t.unbind(-3)
    d12, d01, d02 = fq_sub16(
        torch.stack((x12, x01, x02), -3),
        fq_add16(torch.stack((t1, t0, t0), -3), torch.stack((t2, t1, t2), -3)),
    ).unbind(-3)
    xi = f2_mul_xi16(torch.stack((d12, t2), -3))
    return fq_add16(torch.stack((t0, d01, d02), -3), torch.stack((xi[..., 0, :, :], xi[..., 1, :, :], t1), -3))


def f6_inv16(a):
    a0, a1, a2 = a.unbind(-3)
    sq = f2_sqr16(torch.stack((a0, a2, a1), -3))
    pr = f2_mul16(torch.stack((a1, a0, a0), -3), torch.stack((a2, a1, a2), -3))
    c0 = fq_sub16(sq[..., 0, :, :], f2_mul_xi16(pr[..., 0, :, :]))
    c1 = fq_sub16(f2_mul_xi16(sq[..., 1, :, :]), pr[..., 1, :, :])
    c2 = fq_sub16(sq[..., 2, :, :], pr[..., 2, :, :])
    m = f2_mul16(torch.stack((a0, a2, a1), -3), torch.stack((c0, c1, c2), -3))
    denom = fq_add16(m[..., 0, :, :], f2_mul_xi16(fq_add16(m[..., 1, :, :], m[..., 2, :, :])))
    t = f2_inv16(denom)
    return f2_mul16(torch.stack((c0, c1, c2), -3), t.unsqueeze(-3))


def f6_frob16(a):
    a0, a1, a2 = a.unbind(-3)
    dev = a.device
    g = torch.stack((fq2_const16(HF._G6_1, dev), fq2_const16(HF._G6_2, dev)))
    return torch.stack((f2_conj16(a0), *f2_mul16(f2_conj16(torch.stack((a1, a2), -3)), g).unbind(-3)), -3)


# ---------------------------------------------------------------------------
# Fq12 ([..., 2, 3, 2, 24])
# ---------------------------------------------------------------------------


def f12_one16(shape, dev):
    one = torch.zeros((2, 3, 2, 24), dtype=torch.int64, device=dev)
    one[0, 0, 0] = consts(dev)["one"]
    return one.expand(*shape, 2, 3, 2, 24)


def f12_mul16(a, b):
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a.unbind(-4)
    b0, b1 = b.unbind(-4)
    t0, t1, x = f6_mul16(
        torch.stack((a0, a1, fq_add16(a0, a1)), -4), torch.stack((b0, b1, fq_add16(b0, b1)), -4)
    ).unbind(-4)
    c1 = fq_sub16(x, fq_add16(t0, t1))
    return torch.stack((fq_add16(t0, f6_mul_by_v16(t1)), c1), -4)


def f12_sqr16(a):
    a0, a1 = a.unbind(-4)
    t, x = f6_mul16(
        torch.stack((a0, fq_add16(a0, a1)), -4), torch.stack((a1, fq_add16(a0, f6_mul_by_v16(a1))), -4)
    ).unbind(-4)
    c0 = fq_sub16(fq_sub16(x, t), f6_mul_by_v16(t))
    return torch.stack((c0, fq_add16(t, t)), -4)


def f12_conj16(a):
    a0, a1 = a.unbind(-4)
    return torch.stack((a0, fq_neg16(a1)), -4)


def f12_inv16(a):
    a0, a1 = a.unbind(-4)
    s0, s1 = f6_mul16(torch.stack((a0, a1), -4), torch.stack((a0, a1), -4)).unbind(-4)
    t = f6_inv16(fq_sub16(s0, f6_mul_by_v16(s1)))
    r0, r1 = f6_mul16(torch.stack((a0, a1), -4), t.unsqueeze(-4)).unbind(-4)
    return torch.stack((r0, fq_neg16(r1)), -4)


def f12_frob16(a):
    b = f6_frob16(a)  # both halves at once
    b0, b1 = b.unbind(-4)
    return torch.stack((b0, f2_mul16(b1, fq2_const16(HF._G12, a.device))), -4)


def f12_is_one16(a):
    one = f12_one16(a.shape[:-4], a.device)
    return (a == one).flatten(-4).all(-1)


def f12_mul_by_045_16(f, c0, c4, c5):
    """f * (c0 + c4 vw + c5 v^2 w) for Fq2 c0, c4, c5 (fields.py
    f12_mul_by_045): ten sparse products and six by c0 in two calls."""
    t = f2_mul16(f, c0.unsqueeze(-3).unsqueeze(-4))  # ta, tb
    ta, tb = t.unbind(-4)
    x0, x1, x2 = f.unbind(-3)  # each [..., 2(halves), 2, 24]
    c4e, c5e = c4.unsqueeze(-3), c5.unsqueeze(-3)
    c45 = fq_add16(c4e, c5e)
    m = f2_mul16(
        torch.stack(torch.broadcast_tensors(x1, x2, fq_add16(x1, x2), x0, x0), -4),
        torch.stack(torch.broadcast_tensors(c4e, c5e, c45, c4e, c5e), -4),
    )
    m1, m2, mx, x0c4, x0c5 = m.unbind(-4)
    l0 = f2_mul_xi16(fq_sub16(fq_sub16(mx, m1), m2))
    l1 = fq_add16(x0c4, f2_mul_xi16(m2))
    l2 = fq_add16(x0c5, m1)
    al1 = torch.stack((l0[..., 0, :, :], l1[..., 0, :, :], l2[..., 0, :, :]), -3)
    bl1 = torch.stack((l0[..., 1, :, :], l1[..., 1, :, :], l2[..., 1, :, :]), -3)
    return torch.stack((fq_add16(ta, f6_mul_by_v16(bl1)), fq_add16(al1, tb)), -4)


def f12_cyclotomic_sqr16(f):
    """Granger-Scott squaring in the cyclotomic subgroup (fields.py
    f12_cyclotomic_sqr): the nine Fq2 squarings in one call."""
    (z0, z4, z3), (z2, z1, z5) = (f[..., 0, :, :, :].unbind(-3), f[..., 1, :, :, :].unbind(-3))
    a = torch.stack((z0, z2, z4), -3)
    b = torch.stack((z1, z3, z5), -3)
    sq = f2_sqr16(torch.stack((a, b, fq_add16(a, b)), -4))
    ta, tb, tab = sq.unbind(-4)
    r0 = fq_add16(f2_mul_xi16(tb), ta)  # a^2 + xi b^2
    r1 = fq_sub16(fq_sub16(tab, ta), tb)  # 2ab
    (t0, t0b, t2), (t1, t1b, t3) = r0.unbind(-3), r1.unbind(-3)

    def minus(z, t):  # 3t - 2z
        d = fq_sub16(t, z)
        return fq_add16(fq_add16(d, d), t)

    def plus(z, t):  # 3t + 2z
        d = fq_add16(t, z)
        return fq_add16(fq_add16(d, d), t)

    n0 = minus(z0, t0)
    n1 = plus(z1, t1)
    n4 = minus(z4, t0b)
    n5 = plus(z5, t1b)
    n2 = plus(z2, f2_mul_xi16(t3))
    n3 = minus(z3, t2)
    return torch.stack((torch.stack((n0, n4, n3), -3), torch.stack((n2, n1, n5), -3)), -4)


def f12_cyclotomic_pow16(f, e: int):
    """f^e, e > 0 (fields.py f12_cyclotomic_pow)."""
    res = f
    for bit in bin(e)[3:]:
        res = f12_cyclotomic_sqr16(res)
        if bit == "1":
            res = f12_mul16(res, f)
    return res


# ---------------------------------------------------------------------------
# Public plain ops on the port's [..., 12] limbs (the JAX module's names)
# ---------------------------------------------------------------------------


def _pub(fn):
    def run(*args):
        return to32(fn(*(to16(a) for a in args)))

    run.__name__ = fn.__name__.replace("16", "")
    run.__doc__ = fn.__doc__
    return run


f2_mul = _pub(f2_mul16)
f2_sqr = _pub(f2_sqr16)
f2_inv = _pub(f2_inv16)
f2_mul_xi = _pub(f2_mul_xi16)
f12_mul = _pub(f12_mul16)
f12_sqr = _pub(f12_sqr16)
f12_inv = _pub(f12_inv16)
f12_conj = _pub(f12_conj16)
f12_frob = _pub(f12_frob16)
f12_cyclotomic_sqr = _pub(f12_cyclotomic_sqr16)


def f12_frob2(a):
    return f12_frob(f12_frob(a))


def f12_pow_bits(a, e: int):
    """a^e for a fixed exponent e > 0 (square-and-multiply)."""
    a16 = to16(a)
    acc = a16
    for bit in bin(e)[3:]:
        acc = f12_sqr16(acc)
        if bit == "1":
            acc = f12_mul16(acc, a16)
    return to32(acc)


assert R_MONT > 4 * P  # lazy sums of two reduced values fit one Montgomery reduction
