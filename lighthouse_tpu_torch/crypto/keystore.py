"""EIP-2335 encrypted BLS keystores (crypto/eth2_keystore analog).

scrypt or pbkdf2 KDF (hashlib-native) + AES-128-CTR cipher + sha256
checksum, JSON layout per the EIP; validated against the EIP-2335 test
vectors in tests/test_keystore.py."""

from __future__ import annotations

import hashlib
import json
import os
import uuid as _uuid

from .aes import aes128_ctr


class KeystoreError(ValueError):
    pass


def _kdf_derive(kdf: dict, password: bytes) -> bytes:
    fn = kdf["function"]
    params = kdf["params"]
    salt = bytes.fromhex(params["salt"])
    if fn == "scrypt":
        return hashlib.scrypt(
            password,
            salt=salt,
            n=params["n"],
            r=params["r"],
            p=params["p"],
            dklen=params["dklen"],
            maxmem=2 * 128 * params["n"] * params["r"] + (1 << 20),
        )
    if fn == "pbkdf2":
        if params.get("prf", "hmac-sha256") != "hmac-sha256":
            raise KeystoreError(f"unsupported prf {params.get('prf')}")
        return hashlib.pbkdf2_hmac(
            "sha256", password, salt, params["c"], dklen=params["dklen"]
        )
    raise KeystoreError(f"unsupported kdf {fn}")


def _normalize_password(password: str) -> bytes:
    """EIP-2335: NFKD normalize, strip C0/C1/DEL control codes."""
    import unicodedata

    norm = unicodedata.normalize("NFKD", password)
    stripped = "".join(
        c
        for c in norm
        if not (ord(c) < 0x20 or 0x7F <= ord(c) <= 0x9F)
    )
    return stripped.encode("utf-8")


class Keystore:
    """One EIP-2335 keystore document."""

    def __init__(self, doc: dict):
        self.doc = doc

    # -- construction ---------------------------------------------------------

    @classmethod
    def encrypt(
        cls,
        secret: bytes,
        password: str,
        path: str = "",
        kdf: str = "scrypt",
        pubkey: bytes | None = None,
        description: str = "",
        _fast_kdf: bool = False,
    ) -> "Keystore":
        if len(secret) != 32:
            # EIP-2335 proper encrypts 32-byte BLS secrets. The single
            # sanctioned exception: EIP-2386 wallet SEEDS (≥32 bytes),
            # marked by an explicitly EMPTY pubkey — a caller passing a
            # real pubkey still gets its secret length validated.
            if not (pubkey == b"" and len(secret) >= 32):
                raise KeystoreError("BLS secret must be 32 bytes")
        salt = os.urandom(32)
        iv = os.urandom(16)
        if kdf == "scrypt":
            n = 2**10 if _fast_kdf else 2**18
            kdf_module = {
                "function": "scrypt",
                "params": {
                    "dklen": 32,
                    "n": n,
                    "r": 8,
                    "p": 1,
                    "salt": salt.hex(),
                },
                "message": "",
            }
        elif kdf == "pbkdf2":
            c = 2**10 if _fast_kdf else 2**18
            kdf_module = {
                "function": "pbkdf2",
                "params": {
                    "dklen": 32,
                    "c": c,
                    "prf": "hmac-sha256",
                    "salt": salt.hex(),
                },
                "message": "",
            }
        else:
            raise KeystoreError(f"unsupported kdf {kdf}")
        dk = _kdf_derive(kdf_module, _normalize_password(password))
        cipher_text = aes128_ctr(dk[:16], iv, secret)
        checksum = hashlib.sha256(dk[16:32] + cipher_text).digest()
        if pubkey is None:
            from . import bls

            pubkey = bls.SecretKey.from_bytes(secret).public_key().to_bytes()
        doc = {
            "crypto": {
                "kdf": kdf_module,
                "checksum": {
                    "function": "sha256",
                    "params": {},
                    "message": checksum.hex(),
                },
                "cipher": {
                    "function": "aes-128-ctr",
                    "params": {"iv": iv.hex()},
                    "message": cipher_text.hex(),
                },
            },
            "description": description,
            "pubkey": pubkey.hex(),
            "path": path,
            "uuid": str(_uuid.uuid4()),
            "version": 4,
        }
        return cls(doc)

    # -- decryption -----------------------------------------------------------

    def decrypt(self, password: str) -> bytes:
        crypto = self.doc["crypto"]
        if self.doc.get("version") != 4:
            raise KeystoreError("only EIP-2335 v4 keystores supported")
        dk = _kdf_derive(crypto["kdf"], _normalize_password(password))
        cipher = crypto["cipher"]
        if cipher["function"] != "aes-128-ctr":
            raise KeystoreError(f"unsupported cipher {cipher['function']}")
        cipher_text = bytes.fromhex(cipher["message"])
        checksum = hashlib.sha256(dk[16:32] + cipher_text).digest()
        if checksum.hex() != crypto["checksum"]["message"]:
            raise KeystoreError("invalid password (checksum mismatch)")
        return aes128_ctr(
            dk[:16], bytes.fromhex(cipher["params"]["iv"]), cipher_text
        )

    # -- plumbing -------------------------------------------------------------

    @property
    def pubkey(self) -> bytes:
        return bytes.fromhex(self.doc["pubkey"])

    @property
    def uuid(self) -> str:
        return self.doc["uuid"]

    @property
    def path(self) -> str:
        return self.doc.get("path", "")

    def to_json(self) -> str:
        return json.dumps(self.doc)

    @classmethod
    def from_json(cls, data: str | bytes) -> "Keystore":
        doc = json.loads(data)
        if "crypto" not in doc:
            raise KeystoreError("not a keystore document")
        return cls(doc)

    def save(self, path):
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path) -> "Keystore":
        with open(path) as f:
            return cls.from_json(f.read())
