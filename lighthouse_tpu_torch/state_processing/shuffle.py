"""Swap-or-not shuffle (consensus/swap_or_not_shuffle equivalent).

Counterpart of lighthouse_tpu/state_processing/shuffle.py, copied.

`compute_shuffled_index` is the per-index spec algorithm;
`shuffle_list` computes the whole permutation at once, vectorized over numpy
(the reference's whole-list version is ~250× faster per element,
swap_or_not_shuffle/src/lib.rs:1-23 — ours vectorizes the same trick, and the
same structure jits onto the TPU VPU for very large validator sets).
"""

from __future__ import annotations

import numpy as np

from ..utils.hash import sha256 as _hash


def compute_shuffled_index(
    index: int, index_count: int, seed: bytes, rounds: int
) -> int:
    """Spec `compute_shuffled_index` (one index through all rounds)."""
    assert index < index_count
    for r in range(rounds):
        pivot = (
            int.from_bytes(_hash(seed + bytes([r]))[:8], "little") % index_count
        )
        flip = (pivot + index_count - index) % index_count
        position = max(index, flip)
        source = _hash(
            seed + bytes([r]) + (position // 256).to_bytes(4, "little")
        )
        byte = source[(position % 256) // 8]
        bit = (byte >> (position % 8)) & 1
        index = flip if bit else index
    return index


def shuffle_list(values: list, seed: bytes, rounds: int) -> list:
    """Return out with out[i] == values[compute_shuffled_index(i)] — the
    ordering spec committees slice into (compute_committee indexes
    indices[compute_shuffled_index(pos)]). One vectorized pass per round."""
    n = len(values)
    if n <= 1:
        return list(values)
    perm = _shuffled_positions(n, seed, rounds)
    return [values[perm[i]] for i in range(n)]


def _shuffled_positions(n: int, seed: bytes, rounds: int) -> np.ndarray:
    """positions[i] = compute_shuffled_index(i, n, seed), vectorized.

    Each round needs ⌈n/256⌉ source hashes (one 256-bit output covers
    256 consecutive positions). They are hashed as ONE batched call per
    round over a [m, 37]-byte message matrix (seed ‖ round ‖ chunk-index,
    through utils/sha256_batch.hash_messages) — at 1M validators that is
    ~3.9k messages per round in one pass instead of ~350k sequential
    hashlib calls per shuffle."""
    from ..utils.sha256_batch import hash_messages

    idx = np.arange(n, dtype=np.int64)
    n_chunks = (n + 255) // 256
    # the per-round message matrix: seed(32) | round(1) | chunk LE32(4);
    # only byte 32 (the round) changes between rounds
    msgs = np.empty((n_chunks, 37), dtype=np.uint8)
    msgs[:, :32] = np.frombuffer(seed, dtype=np.uint8)
    msgs[:, 33:] = (
        np.arange(n_chunks, dtype="<u4").view(np.uint8).reshape(n_chunks, 4)
    )
    for r in range(rounds):
        pivot = int.from_bytes(_hash(seed + bytes([r]))[:8], "little") % n
        flip = (pivot + n - idx) % n
        position = np.maximum(idx, flip)
        msgs[:, 32] = r
        digests = hash_messages(msgs)  # [m, 32]
        bits = np.unpackbits(digests.reshape(-1), bitorder="little")
        swap = bits[position].astype(bool)
        idx = np.where(swap, flip, idx)
    return idx
