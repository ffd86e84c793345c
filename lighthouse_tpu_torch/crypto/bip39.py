"""BIP-39 mnemonic encoding (generate / validate / recover).

The reference's wallet creation flows through the `bip39` crate
(account_manager/src/wallet/create.rs: a random `Mnemonic` is generated,
shown to the user, and its 64-byte seed becomes the EIP-2386 wallet
seed; recover reverses it). Same scheme here:

  entropy (128–256 bits) → words: append the first ENT/32 bits of
  SHA-256(entropy) as a checksum, split into 11-bit indices into the
  2048-word list (bip39_words.py).

  mnemonic → seed: PBKDF2-HMAC-SHA512(NFKD(mnemonic),
  "mnemonic"+NFKD(passphrase), 2048 iterations, 64 bytes).
"""

from __future__ import annotations

import hashlib
import os
import unicodedata

from .bip39_words import INDEX, WORDS

_VALID_WORD_COUNTS = {12: 128, 15: 160, 18: 192, 21: 224, 24: 256}


class Bip39Error(ValueError):
    pass


def entropy_to_mnemonic(entropy: bytes) -> str:
    ent = len(entropy) * 8
    if ent not in _VALID_WORD_COUNTS.values():
        raise Bip39Error(f"entropy must be 128–256 bits in 32-bit steps, got {ent}")
    cs = ent // 32
    checksum = hashlib.sha256(entropy).digest()
    # cs ≤ 8, so the checksum bits are the top cs bits of checksum[0]
    bits = (int.from_bytes(entropy, "big") << cs) | (checksum[0] >> (8 - cs))
    n_words = (ent + cs) // 11
    words = []
    for i in range(n_words - 1, -1, -1):
        words.append(WORDS[(bits >> (i * 11)) & 0x7FF])
    return " ".join(words)


def mnemonic_to_entropy(mnemonic: str) -> bytes:
    """Validate the checksum and return the entropy; raises on any
    unknown word, bad word count, or checksum mismatch."""
    words = unicodedata.normalize("NFKD", mnemonic).strip().split()
    if len(words) not in _VALID_WORD_COUNTS:
        raise Bip39Error(f"mnemonic must be 12/15/18/21/24 words, got {len(words)}")
    ent = _VALID_WORD_COUNTS[len(words)]
    cs = ent // 32
    bits = 0
    for w in words:
        idx = INDEX.get(w)
        if idx is None:
            raise Bip39Error(f"unknown BIP-39 word: {w!r}")
        bits = bits << 11 | idx
    checksum = bits & ((1 << cs) - 1)
    entropy = (bits >> cs).to_bytes(ent // 8, "big")
    want = hashlib.sha256(entropy).digest()[0] >> (8 - cs)
    if checksum != want:
        raise Bip39Error("mnemonic checksum mismatch")
    return entropy


def generate_mnemonic(strength_bits: int = 256, entropy: bytes | None = None) -> str:
    if entropy is None:
        entropy = os.urandom(strength_bits // 8)
    return entropy_to_mnemonic(entropy)


def validate_mnemonic(mnemonic: str) -> bool:
    try:
        mnemonic_to_entropy(mnemonic)
        return True
    except Bip39Error:
        return False


def mnemonic_to_seed(mnemonic: str, passphrase: str = "") -> bytes:
    mnemonic_to_entropy(mnemonic)  # reject malformed phrases up front
    norm = unicodedata.normalize("NFKD", mnemonic.strip())
    salt = "mnemonic" + unicodedata.normalize("NFKD", passphrase)
    return hashlib.pbkdf2_hmac(
        "sha512", norm.encode(), salt.encode(), 2048, dklen=64
    )
