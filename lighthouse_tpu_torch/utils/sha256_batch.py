"""Host SHA-256 lanes and the two-to-one row hasher the SSZ layer calls.

Counterpart of lighthouse_tpu/utils/sha256_batch.py, cut to what the SSZ
layer needs. Two host lanes:

  * `hash_rows_hashlib`: one C-speed hashlib pass over a contiguous buffer.
  * `hash_rows_numpy`: multi-buffer lanes, the SHA-256 compression run over
    [N]-wide uint32 arrays, one numpy ufunc per round operation over all
    lanes. The second compression block of a 64-byte message is the
    constant padding block, so its schedule is precomputed once
    (`_KW_PAD`, which the CUDA kernel also carries).

Both are oracles for the kernel (tests, chip_smoke.py). `hash_rows` is the
dispatcher the Merkleization caches call: the hashlib loop below
`_BATCH_MIN` rows, the kernel on the default device from there (see
lighthouse_tpu_torch/device.py). There is no mode switch and no fallback:
the device decides, and a kernel failure raises.

numpy rows are processed in `_CHUNK`-sized slices so the ~30 live [m]
uint32 lanes stay cache-resident instead of streaming 4 MB arrays per ufunc.
"""

from __future__ import annotations

import hashlib

import numpy as np

# fmt: off
_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208, 0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

_IV = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)
# fmt: on

_M32 = 0xFFFFFFFF


def _scalar_schedule(words16: list[int]) -> list[int]:
    """Expand a 16-word block to the 64-entry W schedule (host ints)."""

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & _M32

    w = list(words16) + [0] * 48
    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w[t] = (w[t - 16] + s0 + w[t - 7] + s1) & _M32
    return w


def _pad_block_words(msg_bytes: int) -> list[int]:
    """The final padding block for a message of `msg_bytes` that is an
    exact multiple of 64 (0x80, zeros, 64-bit bit length)."""
    blk = [0] * 16
    blk[0] = 0x80000000
    blk[14] = (msg_bytes * 8) >> 32
    blk[15] = (msg_bytes * 8) & _M32
    return blk


# K[t] + W[t] for the constant padding block of a 64-byte message — the
# whole schedule of the second compression in two-to-one hashing.
_KW_PAD = np.array(
    [(int(k) + w) & _M32 for k, w in zip(_K, _scalar_schedule(_pad_block_words(64)))],
    dtype=np.uint32,
)

# Rows per slice: keeps the ~30 live [m] u32 lanes (~2 MB) cache-resident.
_CHUNK = 1 << 14

# Below this many rows the hashlib loop beats a kernel dispatch.
_BATCH_MIN = 1 << 11


def _rotr_into(x, n, out, tmp):
    np.right_shift(x, np.uint32(n), out=out)
    np.left_shift(x, np.uint32(32 - n), out=tmp)
    np.bitwise_or(out, tmp, out=out)
    return out


def _compress_lanes(state8, kw_rounds, w16, scratch):
    """One SHA-256 compression over [m]-wide lanes, accumulated into state8.

    state8: list of 8 [m] u32 arrays (updated in place).
    kw_rounds: None (derive wt from w16, adding K per round) or a [64] u32
        of precomputed K[t]+W[t] scalars (constant-block fast path).
    w16: list of 16 contiguous [m] u32 arrays (mutated: in-place schedule);
        ignored when kw_rounds is not None.
    scratch: four [m] u32 scratch arrays.
    """
    t1, t2, u, v = scratch
    a, b, c, d, e, f, g, h = (x.copy() for x in state8)
    for t in range(64):
        if kw_rounds is not None:
            kw = kw_rounds[t]
        else:
            if t < 16:
                wt = w16[t]
            else:
                wt = w16[t & 15]
                w15 = w16[(t - 15) & 15]
                w2 = w16[(t - 2) & 15]
                _rotr_into(w15, 7, t1, u)
                _rotr_into(w15, 18, t2, u)
                np.bitwise_xor(t1, t2, out=t1)
                np.right_shift(w15, np.uint32(3), out=t2)
                np.bitwise_xor(t1, t2, out=t1)  # ssig0
                np.add(wt, t1, out=wt)
                _rotr_into(w2, 17, t1, u)
                _rotr_into(w2, 19, t2, u)
                np.bitwise_xor(t1, t2, out=t1)
                np.right_shift(w2, np.uint32(10), out=t2)
                np.bitwise_xor(t1, t2, out=t1)  # ssig1
                np.add(wt, t1, out=wt)
                np.add(wt, w16[(t - 7) & 15], out=wt)
            kw = np.add(wt, _K[t], out=v)  # v aliases kw; consumed before reuse
        # T1 = h + S1(e) + ch(e,f,g) + (K[t] + W[t]), accumulated in h
        _rotr_into(e, 6, t1, u)
        _rotr_into(e, 11, t2, u)
        np.bitwise_xor(t1, t2, out=t1)
        _rotr_into(e, 25, t2, u)
        np.bitwise_xor(t1, t2, out=t1)
        np.add(h, t1, out=h)
        np.bitwise_and(e, f, out=t2)
        np.invert(e, out=u)
        np.bitwise_and(u, g, out=u)
        np.bitwise_xor(t2, u, out=t2)
        np.add(h, t2, out=h)
        np.add(h, kw, out=h)  # h = T1
        # T2 = S0(a) + maj(a,b,c) in t2
        _rotr_into(a, 2, t2, u)
        _rotr_into(a, 13, t1, u)
        np.bitwise_xor(t2, t1, out=t2)
        _rotr_into(a, 22, t1, u)
        np.bitwise_xor(t2, t1, out=t2)
        np.bitwise_and(a, b, out=u)
        np.bitwise_and(a, c, out=t1)
        np.bitwise_xor(u, t1, out=u)
        np.bitwise_and(b, c, out=t1)
        np.bitwise_xor(u, t1, out=u)
        np.add(t2, u, out=t2)  # t2 = T2
        np.add(d, h, out=d)  # d + T1 -> next e
        np.add(h, t2, out=h)  # T1 + T2 -> next a
        a, b, c, d, e, f, g, h = h, a, b, c, d, e, f, g
    for st, x in zip(state8, (a, b, c, d, e, f, g, h)):
        np.add(st, x, out=st)


def _digest_lanes(state8, m: int) -> np.ndarray:
    out = np.empty((m, 8), np.uint32)
    for i, x in enumerate(state8):
        out[:, i] = x
    return out.astype(">u4").view(np.uint8).reshape(m, 32)


def hash_rows_numpy(pairs: np.ndarray) -> np.ndarray:
    """[n, 64] uint8 → [n, 32] uint8 SHA-256, numpy multi-buffer lanes."""
    n = pairs.shape[0]
    out = np.empty((n, 32), np.uint8)
    words = np.ascontiguousarray(pairs).view(">u4").astype(np.uint32)  # [n, 16]
    for s in range(0, n, _CHUNK):
        m = min(_CHUNK, n - s)
        blk = words[s : s + m]
        w16 = [np.ascontiguousarray(blk[:, i]) for i in range(16)]
        state8 = [np.full(m, _IV[i], dtype=np.uint32) for i in range(8)]
        scratch = [np.empty(m, np.uint32) for _ in range(4)]
        _compress_lanes(state8, None, w16, scratch)
        _compress_lanes(state8, _KW_PAD, None, scratch)
        out[s : s + m] = _digest_lanes(state8, m)
    return out


def hash_rows_hashlib(pairs: np.ndarray) -> np.ndarray:
    """[n, 64] uint8 → [n, 32] uint8 via one C-speed hashlib pass over a
    contiguous buffer (no per-row numpy objects)."""
    m = pairs.shape[0]
    data = pairs.tobytes()
    out = bytearray(m * 32)
    mv = memoryview(data)
    sha = hashlib.sha256
    for i in range(m):
        out[i * 32 : (i + 1) * 32] = sha(mv[i * 64 : (i + 1) * 64]).digest()
    # frombuffer over the bytearray: zero-copy AND writable (callers
    # commit these rows into mutable tree layers)
    return np.frombuffer(out, dtype=np.uint8).reshape(m, 32)


def hash_rows(pairs: np.ndarray) -> np.ndarray:
    """[n, 64] uint8 → [n, 32] uint8: THE two-to-one row hasher.

    Below _BATCH_MIN rows: the hashlib loop. From _BATCH_MIN rows: the
    SHA-256 kernel on the default device (ops/sha256.device_hash_rows),
    which on a CPU device runs the kernel's plain PyTorch version. A
    kernel failure raises.
    """
    n = pairs.shape[0]
    if n == 0:
        return np.zeros((0, 32), dtype=np.uint8)
    if n < _BATCH_MIN:
        return hash_rows_hashlib(pairs)
    from ..ops.sha256 import device_hash_rows

    return device_hash_rows(pairs)
