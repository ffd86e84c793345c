"""Batched SHA-256 of 64-byte messages, specialised for SSZ Merkleization.

Counterpart of lighthouse_tpu/ops/sha256.py. Its kernel, ``csrc/sha256.cu``,
replaces that module's jitted ``sha256_pairs`` (lines 104-167 there, with
``merkle_tree_levels``, ``merkleize_device`` and ``device_hash_rows``). It
is bound by 32-bit integer issue, not by bytes: at least 2,300 operations
for each 64-byte message read and 32-byte digest written (the count is
derived in the kernel's header comment).

Layout: raw bytes. A message is a [64] uint8 row (two 32-byte nodes), a
digest a [32] uint8 row, so a tree level is an [m, 32] uint8 array. That
is the byte view of the JAX functions' big-endian [m, 8] uint32 words; the
kernel swaps byte order itself.

Dispatch is by the tensor's device: a CUDA tensor goes to the kernel
(built with nvcc at first use, keyed by a hash of the source, into
``lighthouse_tpu_torch/build/``), a CPU tensor to the plain PyTorch
version ``sha256_rows_plain``. A failed build or launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..utils.sha256_batch import _IV, _K, _KW_PAD, hash_rows_hashlib
from . import cuda_build
from .cuda_build import CudaLibrary

# Tree levels with at most this many parent nodes finish on host.
_HOST_TOP = 1 << 8

LIB = CudaLibrary("sha256.cu", {"sha256_rows": ("p", "p", "i64", "p")})

# Kernel launches and rows hashed on the card, counted where the kernel
# launches and nowhere else.
COUNTS = {"launches": 0, "rows": 0}


def reset_counts() -> None:
    COUNTS["launches"] = 0
    COUNTS["rows"] = 0


SOURCE = LIB.source


def load_kernel():
    """The kernel's shared library, built on first use."""
    return LIB.load()


def ptxas_usage(ptxas_log: str) -> dict:
    """Registers and spill bytes of the kernel from `nvcc -Xptxas -v`."""
    usage = next(iter(cuda_build.ptxas_usage(ptxas_log).values()), {})
    return {k: usage.get(k) for k in ("registers", "spill_store_bytes", "spill_load_bytes")}


def _check_rows(rows: torch.Tensor, width: int, name: str) -> None:
    if rows.dtype != torch.uint8 or rows.dim() != 2 or rows.shape[1] != width:
        raise ValueError(
            f"{name}: expected [n, {width}] uint8, got "
            f"{list(rows.shape)} {rows.dtype}"
        )
    if not rows.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _launch(src: torch.Tensor, dst: torch.Tensor) -> None:
    """The one launch site: hash src [n, 64] into dst [n, 32] on the card."""
    _check_rows(src, 64, "src")
    _check_rows(dst, 32, "dst")
    if src.device != dst.device or src.device.type != "cuda":
        raise ValueError(f"src on {src.device}, dst on {dst.device}: need one CUDA device")
    if src.shape[0] != dst.shape[0]:
        raise ValueError(f"{src.shape[0]} rows in, {dst.shape[0]} rows out")
    if src.data_ptr() % 16 or dst.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")
    n = src.shape[0]
    if n == 0:
        return
    LIB.launch("sha256_rows", src.data_ptr(), dst.data_ptr(), n, device=src.device)
    COUNTS["launches"] += 1
    COUNTS["rows"] += n


# ---------------------------------------------------------------------------
# The plain PyTorch version (the kernel's arithmetic, op for op)
# ---------------------------------------------------------------------------

# Torch on the CPU has no uint32 shifts and no uint64 add: words are held
# in int64 and masked back to 32 bits.
_M32 = 0xFFFFFFFF


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress_plain(state: list, w: list | None) -> list:
    """One compression over [n] int64 word lanes; w=None is the padding
    block of a 64-byte message (precomputed K[t]+W[t])."""
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        if w is None:
            kw = int(_KW_PAD[t])
        else:
            if t >= 16:
                w15, w2 = w[(t - 15) & 15], w[(t - 2) & 15]
                s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
                s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
                w[t & 15] = (w[t & 15] + s0 + w[(t - 7) & 15] + s1) & _M32
            kw = w[t & 15] + int(_K[t])
        t1 = (h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + (g ^ (e & (f ^ g))) + kw) & _M32
        t2 = (_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + ((a & b) | (c & (a | b)))
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    return [(x + y) & _M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """[n, 64] uint8 -> [n, 32] uint8 SHA-256 in plain PyTorch, on the
    rows' own device."""
    _check_rows(rows, 64, "rows")
    n = rows.shape[0]
    by = rows.to(torch.int64).view(n, 16, 4)
    w = [
        (by[:, i, 0] << 24) | (by[:, i, 1] << 16) | (by[:, i, 2] << 8) | by[:, i, 3]
        for i in range(16)
    ]
    st = [torch.full((n,), int(v), dtype=torch.int64, device=rows.device) for v in _IV]
    st = _compress_plain(_compress_plain(st, w), None)
    out = torch.stack([(x >> s) & 0xFF for x in st for s in (24, 16, 8, 0)], dim=1)
    return out.to(torch.uint8)


# ---------------------------------------------------------------------------
# Wrappers (the JAX module's functions)
# ---------------------------------------------------------------------------


def _hash_into(src: torch.Tensor, dst: torch.Tensor) -> None:
    if src.device.type == "cuda":
        _launch(src, dst)
    else:
        dst.copy_(sha256_rows_plain(src))


def sha256_pairs(rows: torch.Tensor) -> torch.Tensor:
    """Hash n 64-byte messages: rows [n, 64] uint8 -> digests [n, 32] uint8,
    on the rows' device (the kernel on a CUDA tensor, the plain version on
    a CPU tensor)."""
    _check_rows(rows, 64, "rows")
    if rows.device.type == "cpu":
        return sha256_rows_plain(rows)
    out = torch.empty((rows.shape[0], 32), dtype=torch.uint8, device=rows.device)
    _launch(rows, out)
    return out


def _host_rows(arr: np.ndarray, width: int) -> torch.Tensor:
    """A CPU tensor over the bytes of `arr` ([n, width] uint8), without a
    copy unless the array is read-only or strided."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8).reshape(-1, width)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def merkle_tree_levels(leaves: np.ndarray, device=None) -> list[np.ndarray]:
    """All levels of the Merkle tree over N 32-byte leaves, N a power of two.

    leaves: [N, 32] uint8. Returns a list of [m, 32] uint8 arrays, index 0
    the root level [1, 32], the last the leaves. Levels above _HOST_TOP rows
    hash on `device`, one launch each, in place in one contiguous buffer
    that is copied back to the host once; the small top of the tree
    finishes on the host.
    """
    dev = resolve_device(device)
    n = leaves.shape[0]
    if n == 0 or n & (n - 1):
        raise ValueError(f"leaf count {n} not a power of two")
    sizes = [n]
    while sizes[-1] > max(_HOST_TOP, 1):
        sizes.append(sizes[-1] // 2)
    buf = torch.empty((sum(sizes), 32), dtype=torch.uint8, device=dev)
    buf[:n].copy_(_host_rows(leaves, 32))
    off = 0
    for m in sizes[:-1]:
        _hash_into(buf[off : off + m].view(m // 2, 64), buf[off + m : off + m + m // 2])
        off += m
    host = buf.cpu().numpy()
    levels, off = [], 0
    for m in sizes:
        levels.append(host[off : off + m])
        off += m
    top = levels[-1]
    while top.shape[0] > 1:
        top = hash_rows_hashlib(top.reshape(-1, 64))
        levels.append(top)
    return levels[::-1]


def merkleize_device(leaves: np.ndarray, device=None) -> np.ndarray:
    """Merkle root of a power-of-two number of leaves. Returns [32] uint8."""
    return merkle_tree_levels(leaves, device)[0][0]


def device_hash_rows(pairs: np.ndarray, device=None) -> np.ndarray:
    """[n, 64] uint8 -> [n, 32] uint8 two-to-one hashing on `device`, for
    any n (no power-of-two padding: nothing here compiles per shape)."""
    m = pairs.shape[0]
    if m == 0:
        return np.zeros((0, 32), dtype=np.uint8)
    dev = resolve_device(device)
    rows = _host_rows(pairs, 64).to(dev)
    return sha256_pairs(rows).cpu().numpy()
