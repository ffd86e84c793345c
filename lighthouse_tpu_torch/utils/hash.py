"""Host-side hashing helpers.

Mirrors the role of `ethereum_hashing` in the reference (used at
consensus/cached_tree_hash/src/cache.rs:4): SHA-256 two-to-one hashing plus the
precomputed zero-subtree hashes. The batched kernel lives in ops/sha256;
this module is the scalar host path.
"""

import hashlib


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def hash32_concat(a: bytes, b: bytes) -> bytes:
    """Hash of the concatenation of two 32-byte values (one Merkle node)."""
    return hashlib.sha256(a + b).digest()


def _zero_hashes(depth: int = 64):
    zh = [b"\x00" * 32]
    for _ in range(depth):
        zh.append(hash32_concat(zh[-1], zh[-1]))
    return zh


# ZERO_HASHES[i] = root of an all-zero subtree of depth i
# (ethereum_hashing's ZERO_HASHES equivalent).
ZERO_HASHES = _zero_hashes()
