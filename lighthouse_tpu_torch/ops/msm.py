"""G1 multi-scalar multiplication by Pippenger's buckets (K9).

Counterpart of lighthouse_tpu/ops/msm.py. Its kernel, ``csrc/msm.cu``,
replaces ``msm_pippenger_device`` (:94) with its host digit preparation
(``_host_digit_prep`` :48, ``g1_msm_pippenger`` :159), the path
``g1_msm_device`` (:186) takes on an accelerator: sum_i s_i * P_i over the
4096 Lagrange points of the KZG setup, for every blob commitment and every
opening proof. The JAX package's other path, ``g1_msm_ladder`` (:172),
per-point 256-bit ladders that it takes on its CPU platform, is not on an
accelerator's path and is not ported.

Layout: points [n, 3, 12] in the port's Jacobian limb layout (ops/bls381.py,
int64), scalars [n, 8] canonical 32-bit words, most significant first,
int32 (ops/fr.py); the result is one Jacobian point [3, 12].

Algorithm (the kernel's and the plain version's, step for step, so both
give the same Jacobian coordinates): 4-bit windows, 64 of them, 15
buckets each; (1) per window and chunk of CHUNK points, the chunk's
points added into the bucket their digit names, in point order; (2) per
window and bucket, the chunks' partial buckets summed in a tree over the
chunk axis (padded to a power of two with infinities); (3) per window
sum_j j * B_j by the running sum from bucket 15 down, then Horner's rule
over the windows from the top (4 doublings and an addition each).

Dispatch is by the tensor's device: a CUDA tensor goes to the kernel, a
CPU tensor to the plain version (``g1_msm_plain``). A failed build or
launch raises.
"""

from __future__ import annotations

import torch

from .bls381 import Fq1, NLIMB, check_limbs, pack32, pt_add, pt_double, pt_inf, segment_sum16, unpack16, where16
from .cuda_build import CudaLibrary

WINDOW = 4
WINDOWS = 64  # 4-bit windows over 256-bit scalars
BUCKETS = 15  # digits 1..15
CHUNK = 32  # points per thread of step 1 (csrc/msm.cu MSM_CHUNK)

# Kernel launches, counted where each kernel launches and nowhere else.
COUNTS = {"msm": 0}

LIB = CudaLibrary("msm.cu", {"msm_g1": ("p", "p", "p", "p", "p", "p", "i64", "i32", "p")})


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def chunks(n: int) -> int:
    """Chunks of step 1: ceil(n / CHUNK) rounded up to a power of two."""
    c = 1
    while c * CHUNK < n:
        c *= 2
    return c


def digits(scalars: torch.Tensor) -> torch.Tensor:
    """[n, 8] canonical words (int32) -> [n, 64] 4-bit digits, least
    significant window first."""
    u = scalars.to(torch.int64) & 0xFFFFFFFF
    w = torch.arange(WINDOWS, device=scalars.device)
    return (u[:, 7 - w // 8] >> (4 * (w % 8))) & 15


def g1_msm_plain(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """The kernel's three steps in PyTorch on 16-bit limbs."""
    F = Fq1
    dev = points.device
    n = points.shape[0]
    nc = chunks(n)
    px, py, pz = unpack16(points, 1)
    dig = digits(scalars)  # [n, 64]
    # step 1: lanes (window, chunk), 15 buckets each: [64, nc, 15, 24]
    bx, by, bz = (c.expand(WINDOWS, nc, BUCKETS, -1).clone() for c in pt_inf(F, (), dev))
    base = torch.arange(nc, device=dev) * CHUNK
    for k in range(CHUNK):
        idx = base + k
        valid = idx < n
        i = idx.clamp(max=max(n - 1, 0))
        d = torch.where(valid, dig[i].T, 0)  # [64, nc]
        sel = (d - 1).clamp(min=0)[..., None, None].expand(WINDOWS, nc, 1, bx.shape[-1])
        cur = tuple(b.gather(2, sel).squeeze(2) for b in (bx, by, bz))
        pt = tuple(c[i].expand(WINDOWS, nc, -1) for c in (px, py, pz))
        new = tuple(where16(d > 0, a, b) for a, b in zip(pt_add(F, cur, pt), cur))
        for b, v in zip((bx, by, bz), new):
            b.scatter_(2, sel, v.unsqueeze(2))
    # step 2: [64 * 15, nc] partial buckets -> [64, 15] bucket sums
    part = tuple(b.permute(0, 2, 1, 3).reshape(WINDOWS * BUCKETS, nc, -1) for b in (bx, by, bz))
    sums = tuple(c.reshape(WINDOWS, BUCKETS, -1) for c in segment_sum16(F, part))
    # step 3: running sums per window, then Horner from the top window
    running = pt_inf(F, (WINDOWS,), dev)
    acc = running
    for j in range(BUCKETS - 1, -1, -1):
        running = pt_add(F, running, tuple(c[:, j] for c in sums))
        acc = pt_add(F, acc, running)
    total = pt_inf(F, (), dev)
    for w in range(WINDOWS - 1, -1, -1):
        for _ in range(WINDOW):
            total = pt_double(F, total)
        total = pt_add(F, total, tuple(c[w] for c in acc))
    return pack32(total, 1)


def g1_msm(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """sum_i s_i * P_i: points [n, 3, 12] Jacobian limbs (int64), scalars
    [n, 8] canonical words (int32), n >= 1 -> one Jacobian point [3, 12]."""
    check_limbs(points, (3, NLIMB), "points")
    n = points.shape[0]
    if n < 1 or points.dim() != 3:
        raise ValueError(f"points: expected [n >= 1, 3, 12], got {list(points.shape)}")
    if scalars.dtype != torch.int32 or tuple(scalars.shape) != (n, 8) or not scalars.is_contiguous():
        raise ValueError(f"scalars: expected contiguous [{n}, 8] int32, got {list(scalars.shape)} {scalars.dtype}")
    if points.device.type == "cpu":
        return g1_msm_plain(points, scalars)
    dev = points.device
    if dev.type != "cuda" or scalars.device != dev:
        raise ValueError(f"points on {points.device}, scalars on {scalars.device}: need one CUDA device")
    nc = chunks(n)
    p3 = 3 * NLIMB
    partial = torch.empty((WINDOWS * BUCKETS * nc, p3), dtype=torch.int64, device=dev)
    buf = torch.empty((WINDOWS * BUCKETS * max(nc // 2, 1), p3), dtype=torch.int64, device=dev)
    sums = torch.empty((WINDOWS * BUCKETS, p3), dtype=torch.int64, device=dev)
    out = torch.empty((3, NLIMB), dtype=torch.int64, device=dev)
    LIB.launch(
        "msm_g1", points.data_ptr(), scalars.data_ptr(), partial.data_ptr(), buf.data_ptr(), sums.data_ptr(),
        out.data_ptr(), n, nc, device=dev,
    )
    COUNTS["msm"] += 1
    return out
