"""SHA-256 of 64-byte rows in plain PyTorch (FIPS 180-4), for the reference
state root.

Every Merkle node is the hash of two 32-byte children, so a tree level is one
call: [n, 64] uint8 rows in, [n, 32] digests out. Words are held in int64 and
masked to 32 bits, so the same code runs on the CPU and on a CUDA device.
"""

from __future__ import annotations

import torch

_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
_H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
_M = 0xFFFFFFFF
# Rows hashed per pass: bounds the int64 temporaries (about 2 KiB a row).
CHUNK_ROWS = 1 << 20


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M


def _padding_schedule() -> list[int]:
    """The message schedule of the second block of a 64-byte message: 0x80,
    zeros, and the bit length 512. It is the same for every row."""
    w = [0x80000000] + [0] * 14 + [512]
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M)
    return w


_PAD_W = _padding_schedule()


def _trot(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M


def _compress(state: list, w: list) -> list:
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _trot(e, 6) ^ _trot(e, 11) ^ _trot(e, 25)
        ch = (e & f) ^ ((~e) & _M & g)
        t1 = (h + s1 + ch + _K[t] + w[t]) & _M
        s0 = _trot(a, 2) ^ _trot(a, 13) ^ _trot(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & _M
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M, c, b, a, (t1 + t2) & _M
    return [(x + y) & _M for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _hash_chunk(rows: torch.Tensor) -> torch.Tensor:
    n = rows.shape[0]
    x = rows.to(torch.int64).reshape(n, 16, 4)
    words = (x[:, :, 0] << 24) | (x[:, :, 1] << 16) | (x[:, :, 2] << 8) | x[:, :, 3]
    w = [words[:, t] for t in range(16)]
    for t in range(16, 64):
        s0 = _trot(w[t - 15], 7) ^ _trot(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _trot(w[t - 2], 17) ^ _trot(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M)
    state = [torch.full((n,), v, dtype=torch.int64, device=rows.device) for v in _H0]
    state = _compress(state, w)
    state = _compress(state, _PAD_W)
    out = torch.stack(state, 1)
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=rows.device)
    return ((out.unsqueeze(-1) >> shifts) & 0xFF).to(torch.uint8).reshape(n, 32)


def sha256_rows(rows: torch.Tensor) -> torch.Tensor:
    """SHA-256 of each 64-byte row: [n, 64] uint8 -> [n, 32] uint8, on the
    rows' device."""
    if rows.dtype != torch.uint8 or rows.dim() != 2 or rows.shape[1] != 64:
        raise ValueError(f"expected [n, 64] uint8 rows, got {list(rows.shape)} {rows.dtype}")
    if rows.shape[0] <= CHUNK_ROWS:
        return _hash_chunk(rows)
    return torch.cat([_hash_chunk(rows[i : i + CHUNK_ROWS]) for i in range(0, rows.shape[0], CHUNK_ROWS)])
