"""SSZ Merkleization primitives (tree_hash equivalent).

Re-implements the capability of the reference's `tree_hash` crate
(BYTES_PER_CHUNK=32, used at consensus/cached_tree_hash/src/cache.rs:7):
pack / merkleize / mix_in_length / mix_in_selector per the SSZ spec.

Two execution paths, chosen by size:
  * host: hashlib loop (fast for small trees — no dispatch overhead)
  * device: the batched SHA-256 kernel (ops/sha256.merkleize_device) for
    big trees, one launch per level on the default device.
"""

from __future__ import annotations

import numpy as np

from ..utils.hash import ZERO_HASHES, hash32_concat

BYTES_PER_CHUNK = 32

# Below this many chunks the host loop beats device dispatch.
_DEVICE_THRESHOLD = 1 << 11


def next_pow_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def pack_bytes(data: bytes) -> list[bytes]:
    """Right-pad serialized basic values to a whole number of 32-byte chunks."""
    if len(data) % BYTES_PER_CHUNK:
        data = data + b"\x00" * (BYTES_PER_CHUNK - len(data) % BYTES_PER_CHUNK)
    return [data[i : i + BYTES_PER_CHUNK] for i in range(0, len(data), BYTES_PER_CHUNK)]


def _merkleize_host(chunks: list[bytes], depth: int) -> bytes:
    nodes = list(chunks)
    for level in range(depth):
        if len(nodes) & 1:
            nodes.append(ZERO_HASHES[level])
        nodes = [hash32_concat(nodes[i], nodes[i + 1]) for i in range(0, len(nodes), 2)]
    return nodes[0] if nodes else ZERO_HASHES[depth]


def _merkleize_device(data: bytes, depth: int) -> bytes:
    from ..ops.sha256 import merkleize_device

    n_chunks = len(data) // BYTES_PER_CHUNK
    full = next_pow_of_two(n_chunks)
    sub_depth = (full - 1).bit_length()
    leaves = np.zeros((full, BYTES_PER_CHUNK), dtype=np.uint8)
    leaves.reshape(-1)[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    root = merkleize_device(leaves).tobytes()
    # Fold the real subtree root up against zero subtrees to the target depth.
    for level in range(sub_depth, depth):
        root = hash32_concat(root, ZERO_HASHES[level])
    return root


def merkleize(chunks: list[bytes] | bytes, limit: int | None = None) -> bytes:
    """Merkle root of `chunks`, virtually zero-padded to `limit` leaves.

    `chunks` may be a list of 32-byte values or one contiguous buffer.
    """
    if isinstance(chunks, (bytes, bytearray, memoryview)):
        buf = bytes(chunks)
        assert len(buf) % BYTES_PER_CHUNK == 0
        count = len(buf) // BYTES_PER_CHUNK
    else:
        buf = None
        count = len(chunks)

    if limit is None:
        limit = count
    if count > limit:
        raise ValueError(f"merkleize: {count} chunks exceeds limit {limit}")
    depth = (next_pow_of_two(limit) - 1).bit_length()

    if count >= _DEVICE_THRESHOLD:
        data = buf if buf is not None else b"".join(chunks)
        return _merkleize_device(data, depth)

    if buf is not None:
        chunks = [buf[i : i + 32] for i in range(0, len(buf), 32)]
    return _merkleize_host(list(chunks), depth)


def merkleize_array(leaves: np.ndarray, limit: int | None = None) -> bytes:
    """Merkleize a [N, 32] uint8 numpy array of chunks (bulk path)."""
    return merkleize(leaves.tobytes(), limit)


def mix_in_length(root: bytes, length: int) -> bytes:
    return hash32_concat(root, length.to_bytes(32, "little"))


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return hash32_concat(root, selector.to_bytes(32, "little"))
