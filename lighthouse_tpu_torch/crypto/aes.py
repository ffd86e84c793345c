"""Minimal pure-Python AES-128 + CTR mode.

Keystore decryption (EIP-2335) needs AES-128-CTR and no crypto library is
installable in this image; key management is host-side cold-path code, so
a straightforward table-based implementation suffices (the reference links
a native AES via the `aes` crate)."""

from __future__ import annotations

_SBOX = None


def _build_sbox():
    # multiplicative inverse table over GF(2^8) + affine transform
    p, q = 1, 1
    inv = [0] * 256
    while True:
        # p *= 3
        p = p ^ ((p << 1) & 0xFF) ^ (0x1B if p & 0x80 else 0)
        # q /= 3
        q ^= (q << 1) & 0xFF
        q ^= (q << 2) & 0xFF
        q ^= (q << 4) & 0xFF
        if q & 0x80:
            q ^= 0x09
        inv[p] = q
        if p == 1:
            break
    inv[0] = 0
    sbox = [0] * 256
    for i in range(256):
        x = inv[i] if i else 0
        x = x ^ ((x << 1) | (x >> 7)) ^ ((x << 2) | (x >> 6)) ^ (
            (x << 3) | (x >> 5)
        ) ^ ((x << 4) | (x >> 4)) ^ 0x63
        sbox[i] = x & 0xFF
    sbox[0] = 0x63
    return sbox


def _sbox():
    global _SBOX
    if _SBOX is None:
        _SBOX = _build_sbox()
    return _SBOX


def _xtime(a: int) -> int:
    a <<= 1
    if a & 0x100:
        a ^= 0x11B
    return a & 0xFF


def _expand_key(key: bytes) -> list[list[int]]:
    sbox = _sbox()
    assert len(key) == 16
    words = [list(key[i : i + 4]) for i in range(0, 16, 4)]
    rcon = 1
    for i in range(4, 44):
        t = list(words[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = [sbox[b] for b in t]
            t[0] ^= rcon
            rcon = _xtime(rcon)
        words.append([a ^ b for a, b in zip(words[i - 4], t)])
    return [sum(words[4 * r : 4 * r + 4], []) for r in range(11)]


def _encrypt_block(block: bytes, round_keys) -> bytes:
    sbox = _sbox()
    s = [b ^ k for b, k in zip(block, round_keys[0])]
    for rnd in range(1, 11):
        s = [sbox[b] for b in s]
        # shift rows (column-major state layout: s[r + 4c])
        s = [s[(i + 4 * ((i % 4))) % 16] for i in range(16)]
        if rnd != 10:
            t = []
            for c in range(4):
                col = s[4 * c : 4 * c + 4]
                t += [
                    _xtime(col[0]) ^ (_xtime(col[1]) ^ col[1]) ^ col[2] ^ col[3],
                    col[0] ^ _xtime(col[1]) ^ (_xtime(col[2]) ^ col[2]) ^ col[3],
                    col[0] ^ col[1] ^ _xtime(col[2]) ^ (_xtime(col[3]) ^ col[3]),
                    (_xtime(col[0]) ^ col[0]) ^ col[1] ^ col[2] ^ _xtime(col[3]),
                ]
            s = t
        s = [b ^ k for b, k in zip(s, round_keys[rnd])]
    return bytes(s)


def aes128_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    """CTR keystream XOR (en/decryption are identical)."""
    round_keys = _expand_key(key)
    counter = int.from_bytes(iv, "big")
    out = bytearray()
    for i in range(0, len(data), 16):
        ks = _encrypt_block(counter.to_bytes(16, "big"), round_keys)
        counter = (counter + 1) % (1 << 128)
        chunk = data[i : i + 16]
        out += bytes(a ^ b for a, b in zip(chunk, ks))
    return bytes(out)
