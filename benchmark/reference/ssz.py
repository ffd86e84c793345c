"""SSZ Merkleization for the reference, written from the consensus specs'
simple-serialize.md: chunks, zero-padded trees, limits, length mix-ins.

Trees of many leaves are hashed a level at a time through the plain PyTorch
SHA-256 (``sha256.sha256_rows``) on the device the caller names; single
nodes go through ``hashlib``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .sha256 import sha256_rows

ZERO_HASHES = [b"\x00" * 32]
for _ in range(64):
    ZERO_HASHES.append(hashlib.sha256(ZERO_HASHES[-1] * 2).digest())


def h(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def depth_of(limit_chunks: int) -> int:
    return (next_pow2(limit_chunks) - 1).bit_length()


def hash_pairs(rows: np.ndarray, device: str) -> np.ndarray:
    """[n, 64] uint8 -> [n, 32] uint8 digests."""
    if rows.shape[0] < 64:
        return np.frombuffer(
            b"".join(hashlib.sha256(r.tobytes()).digest() for r in rows), np.uint8
        ).reshape(-1, 32)
    out = sha256_rows(torch.from_numpy(np.ascontiguousarray(rows)).to(device))
    return out.cpu().numpy()


def merkleize(leaves: np.ndarray, limit_chunks: int | None, device: str) -> bytes:
    """Root of [m, 32] chunks zero-padded to `limit_chunks` (or to the next
    power of two of m when None)."""
    m = leaves.shape[0]
    limit = m if limit_chunks is None else limit_chunks
    if m > limit:
        raise ValueError(f"{m} chunks over the limit {limit}")
    depth = depth_of(limit)
    if m == 0:
        return ZERO_HASHES[depth]
    level = np.zeros((next_pow2(m), 32), dtype=np.uint8)
    level[:m] = leaves
    while level.shape[0] > 1:
        level = hash_pairs(level.reshape(-1, 64), device)
    root = level[0].tobytes()
    for d in range(depth_of(m), depth):
        root = h(root, ZERO_HASHES[d])
    return root


def mix_in_length(root: bytes, length: int) -> bytes:
    return h(root, length.to_bytes(32, "little"))


def uint_chunk(v: int, size: int = 8) -> bytes:
    return v.to_bytes(size, "little").ljust(32, b"\x00")


def bytes_chunks(data: bytes) -> np.ndarray:
    buf = np.zeros(-(-len(data) // 32) * 32, dtype=np.uint8)
    buf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    return buf.reshape(-1, 32)


def u64_chunks(values: np.ndarray) -> np.ndarray:
    return bytes_chunks(np.ascontiguousarray(values, dtype="<u8").tobytes())


def container(field_roots: list[bytes]) -> bytes:
    """Root of a container from its fields' roots, in order."""
    level = list(field_roots) + [b"\x00" * 32] * (next_pow2(len(field_roots)) - len(field_roots))
    while len(level) > 1:
        level = [h(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    return level[0]


def fixed_bytes_root(data: bytes) -> bytes:
    """Root of a ByteVector (48, 96, 256 bytes, ...): its chunks merkleized."""
    if len(data) <= 32:
        return data.ljust(32, b"\x00")
    chunks = [data[i : i + 32].ljust(32, b"\x00") for i in range(0, len(data), 32)]
    return container(chunks)


def checkpoint(epoch: int, root: bytes) -> bytes:
    return container([uint_chunk(epoch), root])


def container_rows(columns: list[np.ndarray], device: str) -> np.ndarray:
    """Roots of m containers given their fields as [m, 32] chunk columns, in
    field order: one batched fold of an [m, 2^k, 32] leaf matrix."""
    m = columns[0].shape[0]
    width = next_pow2(len(columns))
    leaves = np.zeros((m, width, 32), dtype=np.uint8)
    for f, col in enumerate(columns):
        leaves[:, f] = col
    level = leaves.reshape(-1, 32)
    while level.shape[0] > m:
        level = hash_pairs(level.reshape(-1, 64), device)
    return level


def u64_column(values: np.ndarray) -> np.ndarray:
    """[m] uint64 -> [m, 32] chunks, each value in its own chunk."""
    out = np.zeros((len(values), 32), dtype=np.uint8)
    out[:, :8] = np.ascontiguousarray(values, dtype="<u8").view(np.uint8).reshape(-1, 8)
    return out
