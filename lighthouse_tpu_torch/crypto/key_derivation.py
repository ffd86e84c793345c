"""EIP-2333 BLS12-381 key derivation (crypto/eth2_key_derivation analog).

hkdf_mod_r master/child derivation + EIP-2334 path parsing, validated
against the EIP-2333 test vectors in tests/test_keystore.py."""

from __future__ import annotations

import hashlib
import hmac as _hmac

from .bls12_381.fields import R as CURVE_ORDER


def _hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return _hmac.new(salt, ikm, hashlib.sha256).digest()


def _hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = _hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def hkdf_mod_r(ikm: bytes, key_info: bytes = b"") -> int:
    """EIP-2333 hkdf_mod_r: derive a nonzero scalar mod the BLS curve
    order; loops with an incrementing salt until nonzero."""
    salt = b"BLS-SIG-KEYGEN-SALT-"
    sk = 0
    while sk == 0:
        salt = hashlib.sha256(salt).digest()
        prk = _hkdf_extract(salt, ikm + b"\x00")
        okm = _hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
        sk = int.from_bytes(okm, "big") % CURVE_ORDER
    return sk


def _ikm_to_lamport_sk(ikm: bytes, salt: bytes) -> list[bytes]:
    prk = _hkdf_extract(salt, ikm)
    okm = _hkdf_expand(prk, b"", 255 * 32)
    return [okm[i * 32 : (i + 1) * 32] for i in range(255)]


def _parent_sk_to_lamport_pk(parent_sk: int, index: int) -> bytes:
    salt = index.to_bytes(4, "big")
    ikm = parent_sk.to_bytes(32, "big")
    lamport_0 = _ikm_to_lamport_sk(ikm, salt)
    not_ikm = bytes(b ^ 0xFF for b in ikm)
    lamport_1 = _ikm_to_lamport_sk(not_ikm, salt)
    pk_chunks = [hashlib.sha256(c).digest() for c in lamport_0 + lamport_1]
    return hashlib.sha256(b"".join(pk_chunks)).digest()


def derive_master_sk(seed: bytes) -> int:
    if len(seed) < 32:
        raise ValueError("EIP-2333 seed must be >= 32 bytes")
    return hkdf_mod_r(seed)


def derive_child_sk(parent_sk: int, index: int) -> int:
    return hkdf_mod_r(_parent_sk_to_lamport_pk(parent_sk, index))


def derive_sk_from_path(seed: bytes, path: str) -> int:
    """EIP-2334 path (m/12381/3600/i/0/0) → secret scalar."""
    parts = path.strip().split("/")
    if parts[0] != "m":
        raise ValueError(f"path must start with m: {path}")
    sk = derive_master_sk(seed)
    for raw in parts[1:]:
        if not raw.isdigit():
            raise ValueError(f"invalid path component {raw!r}")
        sk = derive_child_sk(sk, int(raw))
    return sk


def validator_keypair_path(index: int, kind: str = "signing") -> str:
    """EIP-2334 validator paths: m/12381/3600/<index>/0/0 (signing) and
    m/12381/3600/<index>/0 (withdrawal)."""
    if kind == "signing":
        return f"m/12381/3600/{index}/0/0"
    if kind == "withdrawal":
        return f"m/12381/3600/{index}/0"
    raise ValueError(f"unknown key kind {kind}")
