"""RFC 9380 hash-to-G2 from field elements (K5).

Counterpart of lighthouse_tpu/ops/bls381_htc.py. Its kernel,
``csrc/bls381_htc.cu``, replaces ``hash_to_g2_device`` (:311): two
simplified-SWU maps (``map_to_curve_sswu_device`` :267, with the Fq2
square root ``f2_sqrt_device`` :169 and ``f2_sgn0_device`` :215), the
3-isogeny (``isogeny_to_e2_device`` :295), the pair add and the cofactor
clearing of bls381_pairing.py:440, one thread per message. The host keeps
``expand_message_xmd`` (``messages_to_field``, as the JAX package's
``messages_to_field_device`` :329 does).

Each step computes the host oracle's value (crypto/bls12_381/
hash_to_curve.py); where the oracle branches per message, the kernel
branches and the plain version computes every branch and selects.

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
from .bls381_tower import Fq2, f2_inv16, f2_mul16, f2_sqr16, fq2_const16
from .cuda_build import CudaLibrary

COUNTS = {"hash_to_g2": 0}

LIB = CudaLibrary("bls381_htc.cu", {"bls_hash_to_g2": ("p", "p", "i64", "p")})

_SQRT_EXP = (P + 1) // 4


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


def _sq_eq(s, x):
    return eq16(fq_mul16(s, s), x)


def f2_sqrt16(a):
    """Square root in Fq2 by the host oracle's complex method (fields.py
    f2_sqrt), every branch computed: returns (root, is_square)."""
    x, y = a[..., 0, :], a[..., 1, :]
    zero = torch.zeros_like(x)
    # y == 0: sqrt(x) or sqrt(-x) u; and the norm's root for y != 0
    nx = fq_neg16(x)
    norm = fq_add16(fq_mul16(x, x), fq_mul16(y, y))
    s1, s2, n = fq_pow16(torch.stack((x, nx, norm)), _SQRT_EXP).unbind(0)
    ok1, ok2, ok_n = _sq_eq(s1, x), _sq_eq(s2, nx), _sq_eq(n, norm)
    root_y0 = where16(ok1, torch.stack((s1, zero), -2), torch.stack((zero, s2), -2), 2)
    # y != 0: t^2 = (x + n)/2, else (x - n)/2; root = t + y/(2t) u
    inv2 = fq_const16((P + 1) // 2, a.device)
    halves = fq_mul16(torch.stack((fq_add16(x, n), fq_sub16(x, n))), inv2)
    t = fq_pow16(halves, _SQRT_EXP)
    t_ok = _sq_eq(t, halves) & ~is_zero16(t)
    inv_2t = fq_pow16(fq_add16(t, t), P - 2)
    roots = torch.stack((t, fq_mul16(y.unsqueeze(0), inv_2t)), -2)
    r_ok = t_ok & eq16(f2_sqr16(roots), a.unsqueeze(0), 2)
    root_y = where16(r_ok[0], roots[0], roots[1], 2)
    ok_y = ok_n & (r_ok[0] | r_ok[1])
    y_zero = is_zero16(y)
    root = where16(y_zero, root_y0, root_y, 2)
    ok = torch.where(y_zero, ok1 | ok2, ok_y)
    a_zero = is_zero16(a, 2)
    return where16(a_zero, torch.zeros_like(root), root, 2), ok | a_zero


def _sgn0(a):
    one = torch.zeros_like(a[..., 0, :])
    one[..., 0] = 1
    c = fq_mul16(a, one.unsqueeze(-2))  # out of Montgomery form
    c0, c1 = c[..., 0, :], c[..., 1, :]
    return (c0[..., 0] & 1) | (is_zero16(c0).to(torch.int64) & (c1[..., 0] & 1))


def _gx(x):
    dev = x.device
    return fq_add16(fq_add16(f2_mul16(f2_sqr16(x), x), f2_mul16(_k("_A", dev), x)), _k("_B", dev))


def map_to_curve_sswu16(u):
    dev = u.device
    z_u2 = f2_mul16(_k("_Z", dev), f2_sqr16(u))
    tv = fq_add16(f2_sqr16(z_u2), z_u2)
    one = Fq2.one(dev).expand_as(u)
    x1 = f2_mul16(_k("_MINUS_B_OVER_A", dev), fq_add16(one, f2_inv16(tv)))
    x1 = where16(is_zero16(tv, 2), _k("_B_OVER_ZA", dev).expand_as(u), x1, 2)
    x2 = f2_mul16(z_u2, x1)
    roots, ok = f2_sqrt16(_gx(torch.stack((x1, x2))))
    x = where16(ok[0], x1, x2, 2)
    y = where16(ok[0], roots[0], roots[1], 2)
    flip = _sgn0(u) != _sgn0(y)
    return x, where16(flip, fq_neg16(y), y, 2)


def isogeny_to_e2_16(x, y):
    dev = x.device
    di = f2_inv16(fq_sub16(x, _k("_X0", dev)))
    di2 = f2_sqr16(di)
    di3 = f2_mul16(di2, di)
    t, u = _k("_T", dev), _k("_U", dev)
    phi_x = fq_add16(fq_add16(x, f2_mul16(t, di)), f2_mul16(u, di2))
    phi_x = f2_mul16(phi_x, _k("_INV9", dev))
    one = Fq2.one(dev).expand_as(x)
    deriv = fq_sub16(fq_sub16(one, f2_mul16(t, di2)), f2_mul16(fq_add16(u, u), di3))
    phi_y = fq_neg16(f2_mul16(f2_mul16(y, deriv), _k("_INV27", dev)))
    return phi_x, phi_y


def hash_to_g2_16(u):
    """u [m, 2, 2, 24] -> Jacobian G2 (x, y, z), each [m, 2, 24]."""
    m = u.shape[0]
    flat = torch.cat((u[:, 0], u[:, 1]), 0)  # u0 maps, then u1 maps
    px, py = isogeny_to_e2_16(*map_to_curve_sswu16(flat))
    one = Fq2.one(u.device).expand(m, 2, 24)
    s = pt_add(Fq2, (px[:m], py[:m], one), (px[m:], py[m:], one))
    return g2_clear_cofactor16(s)


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

