"""BLS12-381 field arithmetic and batched G1/G2 point kernels (K2).

Counterpart of lighthouse_tpu/ops/bls381.py (and of the point helpers of
ops/bls381_verify.py). Its kernels, ``csrc/bls381_g.cu``, replace the JAX
package's 64-bit RLC ladders (``batch_g1_scalar_mul``/
``batch_g2_scalar_mul``, :481/:487; K11's, ``sharded_rlc_g1_fn``'s
``pt_scalar_mul`` in bls381_sharded.py:56), its tree sums over a padded committee
axis (``g1_sum_reduce`` :492; ``g1_segment_sum``/``g2_sum_reduce``,
bls381_verify.py:103/108) and its batched Jacobian -> affine conversion
(bls381_verify.py:122/138), and the per-point 256-bit ladders of
``g1_msm_ladder`` (msm.py:172; ``scalar_mul_wide``, the K9 ladder). The
field and curve arithmetic they run is in ``csrc/bls381_field.cuh``; its
bound is 32-bit multiply-adds. The G2 ladder runs a warp per lane on the
team code of ``csrc/g2_team.cuh`` (K5's), with a mixed addition where the
point is affine (Z = 1), which gives the same coordinates as the general
one; the G1 ladder runs a warp per lane on ``csrc/g1_team.cuh`` up to
768 lanes and a thread per lane above (the measured crossover, in
``bls381_g.cu``'s header). The conversions to affine run Montgomery's
batch inversion, a lane a thread and a block of 64 lanes: prefix and
suffix products of the lanes' Z (G1) or N(Z) (G2) and one binary
extended-Euclid inverse a block, infinity lanes counted as 1 and written
as (0, 0). The segment sums cut each segment into aligned sub-segments,
a block each, and sum the blocks' roots in a further pass: a worker an
addition at every level, G1's first level a thread an addition (the
Z = 1 forms where an operand is affine), the other levels on teams
(g1_team.cuh's, 8 lanes; g2_team.cuh's, a warp), the same tree and limbs
as the plain version's. The 256-bit ladder is a signed-window chain
(``pt_mul_words``): Booth digits of 4 bits read from the words, a
per-lane table 1 P .. 8 P, then 4 doublings and one signed addition a
window, on a 4-lane team a lane; K11's 64-bit draws run the same chain
over 17 windows (``scalar_mul_wide64``).

Layout: Fq is 12 little-endian 32-bit limbs in Montgomery form with
R = 2^384 (the JAX package's R, so a residue is the same integer in both;
JAX holds it as 48 8-bit limbs, ``limbs_from_jax``/``limbs_to_jax``
repack), held in int64 and always fully reduced. A G1 coordinate is [12],
a G2 coordinate [2, 12]; a Jacobian point is [..., 3, coord] (x, y, z), an
affine one [..., 2, coord]; infinity is z == 0.

Dispatch is by the tensor's device: a CUDA tensor goes to the kernel
(built with nvcc at first use), a CPU tensor to the plain PyTorch version
(``*_plain``), which computes the same Jacobian coordinates. A failed
build or launch raises.

The plain versions work on 24 16-bit limbs internally: products of 16-bit
limbs and sums of 24 of them stay far inside int64 (torch has no unsigned
64-bit arithmetic). Carries resolve exactly with a cumulative maximum over
the limbs (a run of 0xFFFF limbs passes on the carry of the nearest limb
below it).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F_

from ..crypto.bls12_381.fields import P
from .cuda_build import CudaLibrary

NLIMB = 12
R_MONT = 1 << 384
R_INV = pow(R_MONT, -1, P)

# Kernel launches, counted where each kernel launches and nowhere else (a
# segment sum's launcher launches one kernel a pass).
COUNTS = {
    "g1_scalar_mul": 0,
    "g2_scalar_mul": 0,
    "g1_scalar_mul_wide": 0,
    "g1_scalar_mul_wide64": 0,
    "g1_segment_sum": 0,
    "g2_segment_sum": 0,
    "g1_to_affine": 0,
    "g2_to_affine": 0,
}

LIB = CudaLibrary(
    "bls381_g.cu",
    {
        "bls_g1_scalar_mul": ("p", "p", "p", "i64", "p"),
        "bls_g1_scalar_mul_layout": ("p", "p", "p", "i64", "i32", "p"),
        "bls_g2_scalar_mul": ("p", "p", "p", "i64", "p"),
        "bls_g1_scalar_mul_wide": ("p", "p", "p", "i64", "p"),
        "bls_g1_scalar_mul_wide_layout": ("p", "p", "p", "i64", "i32", "p"),
        "bls_g1_scalar_mul_wide64": ("p", "p", "p", "i64", "p"),
        "bls_g1_segment_sum": ("p", "p", "p", "i64", "i32", "p"),
        "bls_g2_segment_sum": ("p", "p", "p", "i64", "i32", "p"),
        "bls_segment_sum_plan": ("i32", "i64", "i32", "p"),
        "bls_g1_to_affine": ("p", "p", "i64", "p"),
        "bls_g2_to_affine": ("p", "p", "i64", "p"),
    },
)


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


# ---------------------------------------------------------------------------
# Host <-> limb conversion
# ---------------------------------------------------------------------------


def fq_to_limbs(values) -> np.ndarray:
    """Field ints -> [n, 12] int64 Montgomery limbs."""
    buf = b"".join((v * R_MONT % P).to_bytes(48, "little") for v in values)
    return np.frombuffer(buf, dtype="<u4").reshape(-1, NLIMB).astype(np.int64)


def fq_from_limbs(arr) -> list[int]:
    """[..., 12] Montgomery limbs -> field ints (flattened)."""
    raw = np.ascontiguousarray(np.asarray(arr).reshape(-1, NLIMB).astype("<u4")).tobytes()
    return [
        int.from_bytes(raw[48 * i : 48 * i + 48], "little") * R_INV % P
        for i in range(len(raw) // 48)
    ]


def limbs_from_jax(arr) -> np.ndarray:
    """JAX's [..., 48] int32 8-bit limbs -> the port's [..., 12] int64
    32-bit limbs (a byte repack: both packages use R = 2^384)."""
    a = np.asarray(arr)
    by = np.ascontiguousarray(a.astype(np.uint8).reshape(*a.shape[:-1], NLIMB, 4))
    return by.view("<u4")[..., 0].astype(np.int64)


def limbs_to_jax(arr) -> np.ndarray:
    """The port's [..., 12] 32-bit limbs -> JAX's [..., 48] int32 8-bit limbs."""
    a = np.ascontiguousarray(np.asarray(arr).astype("<u4"))
    return a.view(np.uint8).reshape(*a.shape[:-1], 4 * NLIMB).astype(np.int32)


def g1_to_limbs(points) -> np.ndarray:
    """Host Jacobian G1 int triples -> [n, 3, 12]."""
    return fq_to_limbs([c for pt in points for c in pt]).reshape(-1, 3, NLIMB)


def g2_to_limbs(points) -> np.ndarray:
    """Host Jacobian G2 triples of Fq2 pairs -> [n, 3, 2, 12]."""
    return fq_to_limbs([v for pt in points for c in pt for v in c]).reshape(-1, 3, 2, NLIMB)


def g1_from_limbs(arr) -> list:
    v = fq_from_limbs(arr)
    return [tuple(v[i : i + 3]) for i in range(0, len(v), 3)]


def g2_from_limbs(arr) -> list:
    v = fq_from_limbs(arr)
    return [
        tuple((v[i + 2 * c], v[i + 2 * c + 1]) for c in range(3)) for i in range(0, len(v), 6)
    ]


def scalars_to_tensor(scalars) -> torch.Tensor:
    """64-bit scalars -> [n] int64 holding their bit patterns."""
    return torch.tensor([s - (1 << 64) if s >= 1 << 63 else s for s in scalars], dtype=torch.int64)


# ---------------------------------------------------------------------------
# The plain versions' field core: [..., 24] int64 16-bit limbs
# ---------------------------------------------------------------------------

_M16 = 0xFFFF
_W = 24


def to16(x: torch.Tensor) -> torch.Tensor:
    """[..., 12] 32-bit limbs -> [..., 24] 16-bit limbs."""
    return torch.stack((x & _M16, x >> 16), dim=-1).flatten(-2)


def to32(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0::2] | (x[..., 1::2] << 16)


def _limbs16(v: int, n: int = _W) -> list[int]:
    return [(v >> (16 * i)) & _M16 for i in range(n)]


_CONSTS: dict = {}


def consts(dev: torch.device) -> dict:
    """Constant 16-bit limb tensors on `dev` (built once per device)."""
    k = _CONSTS.get(dev)
    if k is None:
        t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)  # noqa: E731
        rr = [_M16] * _W
        rr[0] += 1  # 2^384 as limbs of at least 0xFFFF: a - b + rr >= 0 limb by limb
        k = {
            "p": t(_limbs16(P)),
            "nprime": t(_limbs16((-pow(P, -1, R_MONT)) % R_MONT)),
            "pbar": t(_limbs16(R_MONT - P)),
            "r": t(rr),
            "one": t(_limbs16(R_MONT % P)),
            "idx": torch.arange(2 * _W + 1, dtype=torch.int64, device=dev),
        }
        _CONSTS[dev] = k
    return k


@functools.cache
def fq_const16(v: int, dev) -> torch.Tensor:
    """A field int as [24] 16-bit Montgomery limbs on `dev` (made once;
    callers must not write to it)."""
    return torch.tensor(_limbs16(v * R_MONT % P), dtype=torch.int64, device=dev)


def _conv(a: torch.Tensor, b: torch.Tensor, cols: int) -> torch.Tensor:
    """Columns 0..cols-1 of the limb convolution of a and b: each row of
    the outer product shifted by its index (pad, flatten, re-cut), then
    summed."""
    n = a.shape[-1]
    outer = a.unsqueeze(-1) * b.unsqueeze(-2)
    sk = F_.pad(outer, (0, n)).flatten(-2)[..., : n * (2 * n - 1)]
    return sk.unflatten(-1, (n, 2 * n - 1))[..., :cols].sum(-2)


def _carry(c: torch.Tensor, n: int, bound: int, exact: bool = True) -> torch.Tensor:
    """Exact 16-bit limbs of (sum c_i 2^(16 i)) mod 2^(16 n), for
    coefficients 0 <= c_i < bound. With exact=False the limbs are left in
    [0, 2^16] (the same value mod 2^(16 n), not yet canonical)."""
    m = c.shape[-1]
    if m < n:
        c = F_.pad(c, (0, n - m))
    elif m > n:
        c = c[..., :n]
    top = bound - 1
    while top > 1 << 16:
        c = (c & _M16) + F_.pad((c >> 16)[..., :-1], (1, 0))
        top = _M16 + (top >> 16)
    if not exact:
        return c
    # limbs now in [0, 2^16]: a limb of 2^16 generates a carry, one of
    # 0xFFFF passes an incoming carry on, any other stops it
    idx = consts(c.device)["idx"][:n]
    last = torch.cummax(torch.where(c != _M16, idx, -1), dim=-1).values
    gen = torch.gather(c == (1 << 16), -1, last.clamp(min=0))
    cout = ((last >= 0) & gen).to(torch.int64)
    return (c + F_.pad(cout[..., :-1], (1, 0))) & _M16


def _cond_sub(u: torch.Tensor) -> torch.Tensor:
    """Exact limbs of a value in [0, 2p) -> its residue in [0, p)."""
    w = _carry(u + consts(u.device)["pbar"], _W + 1, 1 << 17)
    return torch.where(w[..., _W:] > 0, w[..., :_W], u)


def _pick(v: torch.Tensor, bound: int) -> torch.Tensor:
    """v = stack(x, x - p + 2^384) of limbs below `bound`, for x in
    [0, 2p): x mod p, both carried in one pass."""
    w = _carry(v, _W + 1, bound)
    return torch.where(w[1, ..., _W:] > 0, w[1, ..., :_W], w[0, ..., :_W])


def fq_mul16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b/R mod p. Inputs below 2p with limbs below
    2^17 (a sum of two reduced values may go in unreduced); output reduced."""
    k = consts(a.device)
    t = _conv(a, b, 2 * _W - 1)  # coefficients < 24 * 2^34
    # m = -t/p mod R; any m of that residue below 2^384 (1 + 2^-16) will do
    m = _carry(_conv(t[..., :_W], k["nprime"], _W), _W, 24 * 24 * 2**50, exact=False)
    s = _carry(t + _conv(m, k["p"], 2 * _W - 1), 2 * _W, 2**40)
    return _cond_sub(s[..., _W:])  # (t + m p)/R < 1.5 p


def fq_add16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    return _pick(torch.stack((s, s + consts(s.device)["pbar"])), 1 << 18)


def fq_sub16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b + p if a < b else a - b: one carry over both candidates, the
    second's top limb telling a >= b."""
    k = consts(a.device)
    d = a - b + k["r"]  # a - b + 2^384
    return _pick(torch.stack((d + k["p"], d)), 3 << 16)


def fq_neg16(a: torch.Tensor) -> torch.Tensor:
    return fq_sub16(torch.zeros_like(a), a)


def fq_pow16(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a fixed exponent (square-and-multiply from the top bit)."""
    acc = consts(a.device)["one"].expand_as(a)
    for bit in bin(e)[2:]:
        acc = fq_mul16(acc, acc)
        if bit == "1":
            acc = fq_mul16(acc, a)
    return acc


def fq_inv16(a: torch.Tensor) -> torch.Tensor:
    return fq_pow16(a, P - 2)  # 0 -> 0


def is_zero16(a: torch.Tensor, dims: int = 1) -> torch.Tensor:
    return (a == 0).flatten(-dims).all(-1)


def eq16(a: torch.Tensor, b: torch.Tensor, dims: int = 1) -> torch.Tensor:
    return (a == b).flatten(-dims).all(-1)


def where16(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, dims: int = 1) -> torch.Tensor:
    """Select per lane: c has the lanes' shape, a and b `dims` more axes."""
    return torch.where(c.reshape(*c.shape, *([1] * dims)), a, b)


# Public plain Fq ops on [..., 12] limbs (the JAX module's names)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return to32(fq_mul16(to16(a), to16(b)))


def mod_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return to32(fq_add16(to16(a), to16(b)))


def mod_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return to32(fq_sub16(to16(a), to16(b)))


def fq_inv(a: torch.Tensor) -> torch.Tensor:
    return to32(fq_inv16(to16(a)))


# ---------------------------------------------------------------------------
# Fields for the generic point code: Fq ([..., 24]) and Fq2 ([..., 2, 24])
# ---------------------------------------------------------------------------


class Fq1:
    dims = 1
    mul = staticmethod(fq_mul16)

    @staticmethod
    def sqr(a):
        return fq_mul16(a, a)

    add = staticmethod(fq_add16)
    sub = staticmethod(fq_sub16)
    neg = staticmethod(fq_neg16)
    inv = staticmethod(fq_inv16)

    @staticmethod
    def one(dev):
        return consts(dev)["one"]


def _fq2():
    from .bls381_tower import Fq2  # the tower imports this module

    return Fq2


# ---------------------------------------------------------------------------
# Jacobian points (the kernels' formulas: csrc/bls381_field.cuh)
# ---------------------------------------------------------------------------


def pt_inf(F, shape, dev):
    one = F.one(dev).expand(*shape, *F.one(dev).shape)
    return (one, one, torch.zeros_like(one))


def pt_double(F, p):
    """2P (curve.py pt_double); an infinity in gives an infinity out."""
    x, y, z = p
    a = F.sqr(x)
    b = F.sqr(y)
    c = F.sqr(b)
    d = F.sub(F.sub(F.sqr(F.add(x, b)), a), c)
    d = F.add(d, d)
    e = F.add(F.add(a, a), a)
    x3 = F.sub(F.sqr(e), F.add(d, d))
    c8 = F.add(c, c)
    c8 = F.add(c8, c8)
    c8 = F.add(c8, c8)
    y3 = F.sub(F.mul(e, F.sub(d, x3)), c8)
    z3 = F.mul(F.add(y, y), z)
    return (x3, y3, z3)


def pt_add(F, p, q):
    """P + Q with curve.py pt_add's cases, as selects per lane: an infinity
    operand passes the other through, P == Q doubles, P == -Q gives the
    canonical infinity (1, 1, 0)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    d = F.dims
    inf1 = is_zero16(z1, d)
    inf2 = is_zero16(z2, d)
    z1z1 = F.sqr(z1)
    z2z2 = F.sqr(z2)
    u1 = F.mul(x1, z2z2)
    u2 = F.mul(x2, z1z1)
    s1 = F.mul(y1, F.mul(z2z2, z2))
    s2 = F.mul(y2, F.mul(z1z1, z1))
    same_x = eq16(u1, u2, d)
    same_y = eq16(s1, s2, d)
    h = F.sub(u2, u1)
    i = F.sqr(F.add(h, h))
    j = F.mul(h, i)
    r = F.sub(s2, s1)
    r = F.add(r, r)
    v = F.mul(u1, i)
    x3 = F.sub(F.sub(F.sqr(r), j), F.add(v, v))
    s1j = F.mul(s1, j)
    y3 = F.sub(F.mul(r, F.sub(v, x3)), F.add(s1j, s1j))
    z3 = F.mul(F.mul(z1, z2), h)
    z3 = F.add(z3, z3)
    out = (x3, y3, z3)
    if bool((same_x & same_y).any()):  # some lane adds a point to itself
        out = tuple(where16(same_x & same_y, a, b, d) for a, b in zip(pt_double(F, p), out))
    inf = pt_inf(F, inf1.shape, z1.device)
    out = tuple(where16(same_x & ~same_y, a, b, d) for a, b in zip(inf, out))
    out = tuple(where16(inf2, a, b, d) for a, b in zip(p, out))
    return tuple(where16(inf1, a, b, d) for a, b in zip(q, out))


def pt_neg(F, p):
    return (p[0], F.neg(p[1]), p[2])


def pt_ladder(F, p, bits):
    """Double-and-add left to right over `bits` ([lanes] bool tensors, most
    significant first) from the canonical infinity; the addition is kept
    where the bit is set."""
    acc = pt_inf(F, bits[0].shape, bits[0].device)
    for bit in bits:
        acc = pt_double(F, acc)
        added = pt_add(F, acc, p)
        acc = tuple(where16(bit, a, b, F.dims) for a, b in zip(added, acc))
    return acc


def pt_mul_u64(F, p, k: torch.Tensor):
    """[k]P for 64-bit scalars k ([lanes] int64 bit patterns), over all 64
    bits."""
    return pt_ladder(F, p, [((k >> i) & 1).bool() for i in range(63, -1, -1)])


# The signed-window chain's window, in bits (csrc/bls381_g.cu WIDE_W)
WIDE_WINDOW = 4


def wide_digits(words: torch.Tensor) -> torch.Tensor:
    """The Booth-recoded digits of scalars of 32 m bits ([lanes, m] 32-bit
    big-endian words: K9's [lanes, 8] int32, or ``u64_words``) -> [lanes,
    32 m // W + 1] int64 (W = WIDE_WINDOW), least significant window
    first: d_i = (window i's low W - 1 bits) + (the bit below it) - 2^(W-1)
    (its top bit), so |d_i| <= 2^(W-1) and sum_i d_i 2^(i W) is the
    scalar."""
    w = WIDE_WINDOW
    u = words.to(torch.int64) & 0xFFFFFFFF
    nbits = 32 * words.shape[-1]
    shifts = torch.arange(32, device=words.device)
    bits = ((u.flip(-1)[..., None] >> shifts) & 1).flatten(-2)  # [lanes, nbits], bit 0 first
    nwin = nbits // w + 1
    # column j is bit j - 1; window i reads columns i W .. i W + W
    padded = F_.pad(bits, (1, nwin * w - nbits))
    fields = padded.unfold(-1, w + 1, w)
    weights = torch.tensor([1] + [1 << j for j in range(w - 1)] + [-(1 << (w - 1))], device=words.device)
    return (fields * weights).sum(-1)


def u64_words(k: torch.Tensor) -> torch.Tensor:
    """[lanes] 64-bit scalars (int64 bit patterns) -> [lanes, 2] int64
    big-endian 32-bit words (high, low), the scalars read unsigned."""
    return torch.stack(((k >> 32) & 0xFFFFFFFF, k & 0xFFFFFFFF), -1)


def wide_table(F, p):
    """1 P .. 2^(W-1) P as coordinates stacked on a new first axis:
    m P = 2 (m / 2) P for an even m, (m - 1) P + P for an odd one."""
    tab = [p]
    for m in range(2, (1 << (WIDE_WINDOW - 1)) + 1):
        tab.append(pt_add(F, tab[m - 2], p) if m & 1 else pt_double(F, tab[m // 2 - 1]))
    return tuple(torch.stack(c) for c in zip(*tab))


def pt_mul_words(F, p, words: torch.Tensor):
    """[k]P for scalars k as [lanes, m] 32-bit big-endian words (K9's
    [lanes, 8] int32 canonical words, ops/fr.py's layout; K11's
    ``u64_words``), the kernel's signed-window chain over 32 m // W + 1
    windows: per
    window, from the top, WIDE_WINDOW doublings and the addition of the
    digit's table entry (its negation for a negative digit; none for 0).
    From the canonical infinity: its doublings keep it and its first
    addition gives the entry, which is where the kernel starts, at the top
    nonzero digit. An infinity result is the canonical (1, 1, 0)."""
    d = F.dims
    dig = wide_digits(words)
    tab = wide_table(F, p)
    lanes = torch.arange(dig.shape[0], device=dig.device)
    acc = pt_inf(F, lanes.shape, lanes.device)
    for i in range(dig.shape[1] - 1, -1, -1):
        for _ in range(WIDE_WINDOW):
            acc = pt_double(F, acc)
        di = dig[:, i]
        x, y, z = (c[(di.abs() - 1).clamp(min=0), lanes] for c in tab)
        entry = (x, where16(di < 0, F.neg(y), y, d), z)
        acc = tuple(where16(di != 0, a, b, d) for a, b in zip(pt_add(F, acc, entry), acc))
    inf = pt_inf(F, lanes.shape, lanes.device)
    return tuple(where16(is_zero16(acc[2], d), a, b, d) for a, b in zip(inf, acc))


def pt_to_affine(F, p):
    """(X/Z^2, Y/Z^3); an infinity gives (0, 0)."""
    x, y, z = p
    zi = F.inv(z)
    zi2 = F.sqr(zi)
    return F.mul(x, zi2), F.mul(y, F.mul(zi2, zi))


def unpack16(t: torch.Tensor, dims: int):
    """[..., k, coord] public limbs -> k coordinates in 16-bit limbs."""
    return tuple(to16(c) for c in t.unbind(-1 - dims))


def pack32(coords, dims: int) -> torch.Tensor:
    return torch.stack([to32(c) for c in coords], dim=-1 - dims)


def segment_sum16(F, pts):
    """Tree sums over axis 1 of [n, k] points (k a power of two): pairs
    (0,1), (2,3), ... then their sums, as the kernel's tree."""
    k = pts[0].shape[1]
    while k > 1:
        lo = tuple(c[:, 0::2] for c in pts)
        hi = tuple(c[:, 1::2] for c in pts)
        pts = pt_add(F, lo, hi)
        k //= 2
    return tuple(c[:, 0] for c in pts)


# ---------------------------------------------------------------------------
# Plain versions of the kernels (public limb layout)
# ---------------------------------------------------------------------------


def _field(group: str):
    return Fq1 if group == "g1" else _fq2()


def scalar_mul_plain(group: str, pts: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    F = _field(group)
    return pack32(pt_mul_u64(F, unpack16(pts, F.dims), k), F.dims)


def scalar_mul_wide_plain(pts: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    return pack32(pt_mul_words(Fq1, unpack16(pts, 1), words), 1)


def scalar_mul_wide64_plain(pts: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return pack32(pt_mul_words(Fq1, unpack16(pts, 1), u64_words(k)), 1)


def segment_sum_plain(group: str, pts: torch.Tensor) -> torch.Tensor:
    F = _field(group)
    return pack32(segment_sum16(F, unpack16(pts, F.dims)), F.dims)


def to_affine_plain(group: str, pts: torch.Tensor) -> torch.Tensor:
    F = _field(group)
    return pack32(pt_to_affine(F, unpack16(pts, F.dims)), F.dims)


# ---------------------------------------------------------------------------
# Wrappers: the kernel on a CUDA tensor, the plain version on a CPU tensor
# ---------------------------------------------------------------------------


def _coord(group: str) -> tuple[int, ...]:
    return (NLIMB,) if group == "g1" else (2, NLIMB)


def check_limbs(t: torch.Tensor, shape_tail: tuple, name: str) -> None:
    if t.dtype != torch.int64 or tuple(t.shape[-len(shape_tail):]) != shape_tail:
        raise ValueError(f"{name}: expected [..., {shape_tail}] int64, got {list(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _cuda_ok(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"tensors on {[str(t.device) for t in ts]}: need one CUDA device")
    return dev


G1_LAYOUTS = ("thread", "team")


def scalar_mul(group: str, pts: torch.Tensor, k: torch.Tensor, layout: str | None = None) -> torch.Tensor:
    """[n, 3, coord] Jacobian points times [n] 64-bit scalars (int64 bit
    patterns) -> [n, 3, coord]. `group` is "g1" or "g2". For "g1" the
    kernel picks its layout by lane count (csrc/bls381_g.cu); `layout`
    ("team": a warp a lane, "thread": a thread a lane) forces one."""
    check_limbs(pts, (3, *_coord(group)), "pts")
    if k.dtype != torch.int64 or k.shape != pts.shape[:1]:
        raise ValueError(f"scalars: expected [{pts.shape[0]}] int64, got {list(k.shape)} {k.dtype}")
    if layout is not None and (group != "g1" or layout not in G1_LAYOUTS):
        raise ValueError(f"layout {layout!r}: only g1 has one, of {G1_LAYOUTS}")
    if pts.device.type == "cpu":
        return scalar_mul_plain(group, pts, k)
    dev = _cuda_ok(pts, k)
    k = k.contiguous()
    out = torch.empty_like(pts)
    n = pts.shape[0]
    if n:
        args = (pts.data_ptr(), k.data_ptr(), out.data_ptr(), n)
        if layout is None:
            LIB.launch(f"bls_{group}_scalar_mul", *args, device=dev)
        else:
            LIB.launch("bls_g1_scalar_mul_layout", *args, G1_LAYOUTS.index(layout), device=dev)
        COUNTS[f"{group}_scalar_mul"] += 1
    return out


def scalar_mul_wide(pts: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """[n, 3, 12] Jacobian G1 points times [n, 8] 256-bit scalars (int32
    canonical big-endian words) -> [n, 3, 12]: the signed-window chain of
    WIDE_WINDOW bits."""
    check_limbs(pts, (3, NLIMB), "pts")
    n = pts.shape[0]
    if pts.dim() != 3:
        raise ValueError(f"pts: expected [n, 3, 12], got {list(pts.shape)}")
    if words.dtype != torch.int32 or tuple(words.shape) != (n, 8) or not words.is_contiguous():
        raise ValueError(f"scalars: expected contiguous [{n}, 8] int32, got {list(words.shape)} {words.dtype}")
    if pts.device.type == "cpu":
        return scalar_mul_wide_plain(pts, words)
    dev = _cuda_ok(pts, words)
    out = torch.empty_like(pts)
    if n:
        LIB.launch("bls_g1_scalar_mul_wide", pts.data_ptr(), words.data_ptr(), out.data_ptr(), n, device=dev)
        COUNTS["g1_scalar_mul_wide"] += 1
    return out


def scalar_mul_wide64(pts: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[n, 3, 12] Jacobian G1 points times [n] 64-bit scalars (int64 bit
    patterns, read unsigned) -> [n, 3, 12]: the signed-window chain of
    ``scalar_mul_wide`` over 17 windows (K11's random linear combination
    draws). Its output is the plain chain's limb for limb, not
    ``scalar_mul``'s (the same points in other Jacobian coordinates)."""
    check_limbs(pts, (3, NLIMB), "pts")
    n = pts.shape[0]
    if pts.dim() != 3:
        raise ValueError(f"pts: expected [n, 3, 12], got {list(pts.shape)}")
    if k.dtype != torch.int64 or tuple(k.shape) != (n,):
        raise ValueError(f"scalars: expected [{n}] int64, got {list(k.shape)} {k.dtype}")
    if pts.device.type == "cpu":
        return scalar_mul_wide64_plain(pts, k)
    dev = _cuda_ok(pts, k)
    k = k.contiguous()
    out = torch.empty_like(pts)
    if n:
        LIB.launch("bls_g1_scalar_mul_wide64", pts.data_ptr(), k.data_ptr(), out.data_ptr(), n, device=dev)
        COUNTS["g1_scalar_mul_wide64"] += 1
    return out


def segment_sum_plan(lib, group: str, n: int, k: int) -> tuple[int, int]:
    """(kernel launches, scratch points) of `lib`'s bls_{group}_segment_sum
    over [n, k]: one launch a pass, and the points of buf its passes use
    (csrc/bls381_g.cu seg_plan)."""
    scratch = ctypes.c_longlong(0)
    passes = lib.bls_segment_sum_plan(int(group == "g2"), n, k, ctypes.addressof(scratch))
    return passes, scratch.value


def segment_sum(group: str, pts: torch.Tensor) -> torch.Tensor:
    """[n, k, 3, coord] points (k a power of two; pad with infinities)
    -> [n, 3, coord] per-row sums: the tree pairs (0, 1), (2, 3), ... and
    then their sums. The kernel runs it in passes over aligned
    sub-segments (csrc/bls381_g.cu), a launch each; buf holds the roots
    between passes."""
    check_limbs(pts, (3, *_coord(group)), "pts")
    n, k = pts.shape[0], pts.shape[1]
    if k < 1 or k & (k - 1):
        raise ValueError(f"segment length {k} is not a power of two")
    if pts.device.type == "cpu":
        return segment_sum_plain(group, pts)
    dev = _cuda_ok(pts)
    out = torch.empty((n, *pts.shape[2:]), dtype=torch.int64, device=dev)
    if n:
        passes, scratch = segment_sum_plan(LIB.load(), group, n, k)
        buf = torch.empty((scratch, *pts.shape[2:]), dtype=torch.int64, device=dev)
        LIB.launch(f"bls_{group}_segment_sum", pts.data_ptr(), buf.data_ptr(), out.data_ptr(), n, k, device=dev)
        COUNTS[f"{group}_segment_sum"] += passes
    return out


def tree_row(pts: torch.Tensor) -> torch.Tensor:
    """[n, 3, coord] points -> [1, k, 3, coord], k the next power of two
    (at least 1), padded with infinities (all-zero rows: Z = 0): one
    segment for ``segment_sum``."""
    n = pts.shape[0]
    k = 1 << (max(n, 1) - 1).bit_length()
    row = torch.zeros((1, k, *pts.shape[1:]), dtype=pts.dtype, device=pts.device)
    row[0, :n] = pts
    return row


def to_affine(group: str, pts: torch.Tensor) -> torch.Tensor:
    """[n, 3, coord] Jacobian -> [n, 2, coord] affine ((0, 0) for infinity).
    The kernel inverts once a block of 64 lanes (Montgomery's batch
    inversion, csrc/bls381_g.cu); its output equals the plain version's,
    which inverts each lane's Z, limb for limb."""
    check_limbs(pts, (3, *_coord(group)), "pts")
    if pts.device.type == "cpu":
        return to_affine_plain(group, pts)
    dev = _cuda_ok(pts)
    n = pts.shape[0]
    out = torch.empty((n, 2, *pts.shape[2:]), dtype=torch.int64, device=dev)
    if n:
        LIB.launch(f"bls_{group}_to_affine", pts.data_ptr(), out.data_ptr(), n, device=dev)
        COUNTS[f"{group}_to_affine"] += 1
    return out
