"""G1 multi-scalar multiplication by Pippenger's buckets (K9).

Counterpart of lighthouse_tpu/ops/msm.py. Its kernels, ``csrc/msm.cu``,
replace ``msm_pippenger_device`` (:94) with its host digit preparation
(``_host_digit_prep`` :48, ``g1_msm_pippenger`` :159), the path
``g1_msm_device`` (:186) takes on an accelerator: sum_i s_i * P_i over the
4096 Lagrange points of the KZG setup, for every blob commitment and every
opening proof.

A fixed-base MSM. ``g1_msm_table(points)`` builds, once per base, the table
T[w][i] = 2^(8w) * P_i of each 8-bit window w < 32, affine, with an
infinity flag (``FixedBaseTable``; 24 MiB at 4096 points, kept on the card
by the KZG engine). ``g1_msm_fixed(table, scalars)`` then sums every table
entry into one set of 255 buckets by its digit (byte w of s_i) and forms
sum_b b * B_b with no Horner chain. ``g1_msm(points, scalars)`` is the
two together, for any points. The table is built on the card in two
launches: the doubling walk (``g1_msm_table_walk``, 8 doublings a window,
a team of lanes a point, Jacobian entries into a scratch buffer), then
K2's batch conversion to affine (``bls381.to_affine``) over all 32n
entries.

``g1_msm_ladder`` is the JAX function of the same name (:172), the path
``g1_msm_device`` takes on the JAX package's CPU platform: per-point
256-bit ladders (``ops/bls381.scalar_mul_wide``, the kernel
``bls_g1_scalar_mul_wide`` of ``csrc/bls381_g.cu``), then one tree sum
(K2's ``segment_sum``). It computes the same sum as ``g1_msm``; it is its
own public function, and the KZG engine stays on Pippenger.

Layout: points [n, 3, 12] in the port's Jacobian limb layout (ops/bls381.py,
int64), scalars [n, 8] canonical 32-bit words, most significant first,
int32 (ops/fr.py); the result is one Jacobian point [3, 12].

Algorithm of ``g1_msm_fixed`` (the kernels' and the plain version's, step
for step, so both give the same Jacobian coordinates): (1) the 32n table
entries in window-major order e = w * n + i dealt into nc chunks (a
power of two, at most CHUNK entries each) by stride, chunk c holding
e = c, c + nc, ...; per chunk and bucket b, the chunk's entries of digit
b added in entry order with mixed additions into an accumulator started
at infinity; (2) per bucket, the
chunks' partial sums added in a tree over the chunk axis; (3) S_k, the
sum of the 128 buckets with bit k of b set (in increasing b), in a tree,
for k < 8; 2^k S_k by k doublings; a tree over the eight.

Dispatch is by the tensor's device: a CUDA tensor goes to the kernel, a
CPU tensor to the plain version (``*_plain``). A failed build or launch
raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .bls381 import (
    Fq1,
    NLIMB,
    _cuda_ok,
    check_limbs,
    eq16,
    fq_inv16,
    fq_mul16,
    is_zero16,
    pack32,
    pt_double,
    pt_inf,
    scalar_mul_wide,
    scalar_mul_wide_plain,
    segment_sum,
    segment_sum16,
    segment_sum_plain,
    to_affine,
    tree_row,
    unpack16,
    where16,
)
from .cuda_build import CudaLibrary

WINDOW = 8
WINDOWS = 32  # 8-bit windows over 256-bit scalars
BUCKETS = 255  # digits 1..255
CHUNK = 1024  # table entries per block of step 1 (csrc/msm.cu MSM_CHUNK)

# Kernel launches, counted where each kernel launches and nowhere else:
# "msm" per fixed-base MSM (three kernels), "msm_table" per doubling walk
# (a table build's own kernel; its conversion to affine is K2's
# "g1_to_affine").
COUNTS = {"msm": 0, "msm_table": 0}

LIB = CudaLibrary(
    "msm.cu",
    {
        "msm_g1_table_walk": ("p", "p", "p", "i64", "p"),
        "msm_g1_fixed": ("p", "p", "p", "p", "p", "p", "p", "i64", "i32", "p"),
    },
)


class FixedBaseTable(NamedTuple):
    """T[w][i] = 2^(8w) * P_i: ``xy`` [32, n, 2, 12] affine limbs (0 at
    infinity), ``inf`` [32, n] bool."""

    xy: torch.Tensor
    inf: torch.Tensor


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def chunks(n: int) -> int:
    """Chunks of step 1 over 32n entries: ceil(32n / CHUNK) rounded up to
    a power of two (so no chunk holds more than CHUNK)."""
    c = 1
    while c * CHUNK < WINDOWS * n:
        c *= 2
    return c


def digits(scalars: torch.Tensor) -> torch.Tensor:
    """[n, 8] canonical words (int32) -> [n, 32] 8-bit digits, least
    significant window first."""
    u = scalars.to(torch.int64) & 0xFFFFFFFF
    w = torch.arange(WINDOWS, device=scalars.device)
    return (u[:, 7 - w // 4] >> (8 * (w % 4))) & 255


def bit_buckets(dev) -> torch.Tensor:
    """[8, 128]: row k the buckets b (1..255) with bit k set, increasing."""
    b = torch.arange(1, BUCKETS + 1, device=dev)
    return torch.stack([b[(b >> k) & 1 == 1] for k in range(WINDOW)])


def pt_add_affine16(p, x2, y2):
    """P + (x2, y2) for Jacobian P and affine (x2, y2) (csrc/msm.cu
    pt_add_affine, madd-2007-bl) with its cases as selects per lane: an
    infinity P gives (x2, y2, 1), P == Q doubles, P == -Q gives the
    canonical infinity."""
    F = Fq1
    x1, y1, z1 = p
    z1z1 = F.sqr(z1)
    u2 = F.mul(x2, z1z1)
    s2 = F.mul(y2, F.mul(z1, z1z1))
    same_x = eq16(x1, u2)
    same_y = eq16(y1, s2)
    h = F.sub(u2, x1)
    hh = F.sqr(h)
    i = F.add(hh, hh)
    i = F.add(i, i)
    j = F.mul(h, i)
    rr = F.sub(s2, y1)
    rr = F.add(rr, rr)
    v = F.mul(x1, i)
    x3 = F.sub(F.sub(F.sqr(rr), j), F.add(v, v))
    t = F.mul(y1, j)
    y3 = F.sub(F.mul(rr, F.sub(v, x3)), F.add(t, t))
    z3 = F.sub(F.sub(F.sqr(F.add(z1, h)), z1z1), hh)
    out = (x3, y3, z3)
    if bool((same_x & same_y).any()):
        out = tuple(where16(same_x & same_y, a, b) for a, b in zip(pt_double(F, p), out))
    inf = pt_inf(F, same_x.shape, z1.device)
    out = tuple(where16(same_x & ~same_y, a, b) for a, b in zip(inf, out))
    one = F.one(z1.device).expand_as(z1)
    return tuple(where16(is_zero16(z1), a, b) for a, b in zip((x2, y2, one), out))


def _walk16(points: torch.Tensor) -> list:
    """2^(8w) P for w < 32, each by 8 doublings of the one before, as
    16-bit limb coordinates."""
    acc = unpack16(points, 1)
    walk = [acc]
    for _ in range(WINDOWS - 1):
        for _ in range(WINDOW):
            acc = pt_double(Fq1, acc)
        walk.append(acc)
    return walk


def g1_msm_table_walk_plain(points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The walk kernel's entries in PyTorch: (T [32, n, 3, 12], inf [32, n])."""
    walk = _walk16(points)
    return torch.stack([pack32(p, 1) for p in walk]), torch.stack([is_zero16(p[2]) for p in walk])


def g1_msm_table_plain(points: torch.Tensor) -> FixedBaseTable:
    """The table in PyTorch: per point, the doubling walk (the walk
    kernel's limbs), then one batch inversion over its 32 Z's (Fermat's).
    The kernels invert in batches of 64 entries by the binary Euclid;
    affine limbs are canonical, so the tables are equal byte for byte."""
    F = Fq1
    one = F.one(points.device).expand(points.shape[0], -1)
    xs, ys, zs, pre, infs = [], [], [], [], []
    for w, acc in enumerate(_walk16(points)):
        at_inf = is_zero16(acc[2])
        z = where16(at_inf, one, acc[2])
        xs.append(acc[0])
        ys.append(acc[1])
        infs.append(at_inf)
        zs.append(z)
        pre.append(z if w == 0 else fq_mul16(pre[-1], z))
    inv = fq_inv16(pre[-1])
    xy = [None] * WINDOWS
    for w in range(WINDOWS - 1, -1, -1):
        if w:
            zi = fq_mul16(inv, pre[w - 1])
            inv = fq_mul16(inv, zs[w])
        else:
            zi = inv
        zi2 = fq_mul16(zi, zi)
        x = fq_mul16(xs[w], zi2)
        y = fq_mul16(ys[w], fq_mul16(zi2, zi))
        zero = torch.zeros_like(x)
        xy[w] = pack32((where16(infs[w], zero, x), where16(infs[w], zero, y)), 1)
    return FixedBaseTable(torch.stack(xy), torch.stack(infs))


def _entry_ranks(dig: torch.Tensor, nc: int) -> torch.Tensor:
    """[nc, 255, m]: per chunk and bucket, its entries in entry order
    (-1 past the last), m the most any (chunk, bucket) holds."""
    dev = dig.device
    e = torch.nonzero(dig).flatten()
    key = (e % nc) * 256 + dig[e]  # chunk c holds e = c, c + nc, ...
    key, order = torch.sort(key, stable=True)
    e = e[order]
    pos = torch.arange(e.numel(), device=dev)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values if e.numel() else pos
    m = int(rank.max()) + 1 if e.numel() else 0
    idx = torch.full((nc * 256, m), -1, dtype=torch.int64, device=dev)
    idx[key, rank] = e
    return idx.reshape(nc, 256, m)[:, 1:]


def g1_msm_fixed_plain(table: FixedBaseTable, scalars: torch.Tensor) -> torch.Tensor:
    """The fixed-base kernels' three steps in PyTorch on 16-bit limbs."""
    F = Fq1
    xy, inf = table
    dev = xy.device
    n = inf.shape[1]
    nc = chunks(n)
    dig = torch.where(inf, 0, digits(scalars).T).reshape(-1)  # window-major
    ex, ey = unpack16(xy.reshape(-1, 2, NLIMB), 1)
    # step 1: lanes (bucket, chunk), the entries of each added in order
    idx = _entry_ranks(dig, nc).transpose(0, 1)  # [255, nc, m]
    acc = pt_inf(F, (BUCKETS, nc), dev)
    for r in range(idx.shape[-1]):
        e = idx[..., r]
        valid = e >= 0
        e = e.clamp(min=0)
        added = pt_add_affine16(acc, ex[e], ey[e])
        acc = tuple(where16(valid, a, b) for a, b in zip(added, acc))
    # step 2: a tree over the chunks of each bucket
    sums = segment_sum16(F, acc)  # [255]
    # step 3: S_k, then 2^k S_k, then a tree over the eight
    s = segment_sum16(F, tuple(c[bit_buckets(dev) - 1] for c in sums))  # [8]
    k = torch.arange(WINDOW, device=dev)
    for d in range(WINDOW - 1):
        s = tuple(where16(k > d, a, b) for a, b in zip(pt_double(F, s), s))
    total = segment_sum16(F, tuple(c[None] for c in s))
    return pack32(tuple(c[0] for c in total), 1)


def g1_msm_plain(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """``g1_msm`` through the plain versions, on any device."""
    _check_msm_args(points, scalars)
    return g1_msm_fixed_plain(g1_msm_table_plain(points), scalars)


def _check_msm_args(points: torch.Tensor, scalars: torch.Tensor | None) -> int:
    check_limbs(points, (3, NLIMB), "points")
    n = points.shape[0]
    if n < 1 or points.dim() != 3:
        raise ValueError(f"points: expected [n >= 1, 3, 12], got {list(points.shape)}")
    if scalars is not None and (scalars.dtype != torch.int32 or tuple(scalars.shape) != (n, 8) or not scalars.is_contiguous()):
        raise ValueError(f"scalars: expected contiguous [{n}, 8] int32, got {list(scalars.shape)} {scalars.dtype}")
    return n


def g1_msm_ladder(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """sum_i s_i * P_i by per-point 256-bit ladders and one tree sum, in the
    layout of ``g1_msm``: the kernels on a CUDA tensor, their plain
    versions on a CPU tensor."""
    _check_msm_args(points, scalars)
    return segment_sum("g1", tree_row(scalar_mul_wide(points, scalars)))[0]


def g1_msm_ladder_plain(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """``g1_msm_ladder`` through the plain versions, on any device."""
    _check_msm_args(points, scalars)
    return segment_sum_plain("g1", tree_row(scalar_mul_wide_plain(points, scalars)))[0]


def _check_table(table: FixedBaseTable, scalars: torch.Tensor) -> int:
    xy, inf = table
    check_limbs(xy, (2, NLIMB), "table.xy")
    if xy.dim() != 4 or xy.shape[0] != WINDOWS or xy.shape[1] < 1:
        raise ValueError(f"table.xy: expected [{WINDOWS}, n >= 1, 2, 12], got {list(xy.shape)}")
    n = xy.shape[1]
    if inf.dtype != torch.bool or tuple(inf.shape) != (WINDOWS, n) or not inf.is_contiguous():
        raise ValueError(f"table.inf: expected contiguous [{WINDOWS}, {n}] bool, got {list(inf.shape)} {inf.dtype}")
    if scalars.dtype != torch.int32 or tuple(scalars.shape) != (n, 8) or not scalars.is_contiguous():
        raise ValueError(f"scalars: expected contiguous [{n}, 8] int32, got {list(scalars.shape)} {scalars.dtype}")
    return n


def g1_msm_table_walk(points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The table's doubling walk: points [n, 3, 12] Jacobian limbs ->
    (T [32, n, 3, 12] Jacobian, inf [32, n] bool), T[w][i] = 2^(8w) P_i by
    8 doublings a window (``pt_double``'s limbs). The kernel runs a 4-lane
    team a point."""
    n = _check_msm_args(points, None)
    if points.device.type == "cpu":
        return g1_msm_table_walk_plain(points)
    dev = _cuda_ok(points)
    jac = torch.empty((WINDOWS, n, 3, NLIMB), dtype=torch.int64, device=dev)
    inf = torch.empty((WINDOWS, n), dtype=torch.bool, device=dev)
    LIB.launch("msm_g1_table_walk", points.data_ptr(), jac.data_ptr(), inf.data_ptr(), n, device=dev)
    COUNTS["msm_table"] += 1
    return jac, inf


def g1_msm_table(points: torch.Tensor) -> FixedBaseTable:
    """The fixed-base table of points [n, 3, 12] Jacobian limbs, n >= 1.
    On the card: the doubling walk (``g1_msm_table_walk``), then K2's
    batch conversion to affine over its 32n entries (``bls381.to_affine``:
    one binary inversion a block of 64, (0, 0) at infinity), whose
    canonical limbs equal the plain version's byte for byte; the Jacobian
    walk (37.7 MB at n = 4096) is freed on return."""
    n = _check_msm_args(points, None)
    if points.device.type == "cpu":
        return g1_msm_table_plain(points)
    jac, inf = g1_msm_table_walk(points)
    xy = to_affine("g1", jac.view(WINDOWS * n, 3, NLIMB)).view(WINDOWS, n, 2, NLIMB)
    return FixedBaseTable(xy, inf)


def g1_msm_fixed(table: FixedBaseTable, scalars: torch.Tensor) -> torch.Tensor:
    """sum_i s_i * P_i over a table of ``g1_msm_table``: scalars [n, 8]
    canonical words (int32) -> one Jacobian point [3, 12]."""
    n = _check_table(table, scalars)
    if table.xy.device.type == "cpu":
        return g1_msm_fixed_plain(table, scalars)
    dev = _cuda_ok(table.xy, table.inf, scalars)
    nc = chunks(n)
    p3 = 3 * NLIMB
    partial = torch.empty((BUCKETS * nc, p3), dtype=torch.int64, device=dev)
    buf = torch.empty((max(BUCKETS * max(nc // 2, 1), WINDOW * 64), p3), dtype=torch.int64, device=dev)
    sums = torch.empty((BUCKETS, p3), dtype=torch.int64, device=dev)
    out = torch.empty((3, NLIMB), dtype=torch.int64, device=dev)
    LIB.launch(
        "msm_g1_fixed", table.xy.data_ptr(), table.inf.data_ptr(), scalars.data_ptr(), partial.data_ptr(),
        buf.data_ptr(), sums.data_ptr(), out.data_ptr(), n, nc, device=dev,
    )
    COUNTS["msm"] += 1
    return out


def g1_msm(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """sum_i s_i * P_i: points [n, 3, 12] Jacobian limbs (int64), scalars
    [n, 8] canonical words (int32), n >= 1 -> one Jacobian point [3, 12]:
    the table of the points, then the fixed-base MSM over it."""
    _check_msm_args(points, scalars)
    return g1_msm_fixed(g1_msm_table(points), scalars)
