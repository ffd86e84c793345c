"""EIP-2386 hierarchical deterministic wallets (crypto/eth2_wallet analog).

A wallet wraps an encrypted seed (reusing the EIP-2335 crypto module) plus
a `nextaccount` counter; each account derives its signing key at the
EIP-2334 validator path. JSON layout per EIP-2386 (type `hierarchical
deterministic`)."""

from __future__ import annotations

import json
import os
import uuid as _uuid

from .key_derivation import derive_sk_from_path, validator_keypair_path
from .keystore import Keystore, KeystoreError


class WalletError(ValueError):
    pass


class Wallet:
    def __init__(self, doc: dict):
        if doc.get("type") != "hierarchical deterministic":
            raise WalletError("not an EIP-2386 HD wallet")
        self.doc = doc

    @classmethod
    def create(
        cls,
        name: str,
        password: str,
        seed: bytes | None = None,
        _fast_kdf: bool = False,
    ) -> "Wallet":
        if seed is None:
            seed = os.urandom(32)
        if len(seed) < 32:
            raise WalletError("seed must be >= 32 bytes")
        # the wallet's crypto section reuses the EIP-2335 crypto over the
        # seed (any length ≥ 32 — e.g. 64-byte BIP39 seeds); no pubkey is
        # derivable from a seed, so an empty one is recorded
        ks = Keystore.encrypt(seed, password, pubkey=b"", _fast_kdf=_fast_kdf)
        doc = {
            "crypto": ks.doc["crypto"],
            "name": name,
            "nextaccount": 0,
            "type": "hierarchical deterministic",
            "uuid": str(_uuid.uuid4()),
            "version": 1,
        }
        return cls(doc)

    def decrypt_seed(self, password: str) -> bytes:
        ks = Keystore({"crypto": self.doc["crypto"], "version": 4})
        return ks.decrypt(password)

    @property
    def name(self) -> str:
        return self.doc["name"]

    @property
    def nextaccount(self) -> int:
        return self.doc["nextaccount"]

    def next_validator(
        self,
        wallet_password: str,
        keystore_password: str,
        _fast_kdf: bool = False,
    ) -> Keystore:
        """Derive the next validator account and return its signing-key
        keystore; bumps `nextaccount` (eth2_wallet_manager behavior)."""
        seed = self.decrypt_seed(wallet_password)
        index = self.doc["nextaccount"]
        path = validator_keypair_path(index, "signing")
        sk = derive_sk_from_path(seed, path)
        ks = Keystore.encrypt(
            sk.to_bytes(32, "big"),
            keystore_password,
            path=path,
            _fast_kdf=_fast_kdf,
        )
        self.doc["nextaccount"] = index + 1
        return ks

    def to_json(self) -> str:
        return json.dumps(self.doc)

    @classmethod
    def from_json(cls, data: str | bytes) -> "Wallet":
        return cls(json.loads(data))

    # -- BIP-39 flows (account_manager/src/wallet/{create,recover}.rs) ------

    @classmethod
    def create_with_mnemonic(
        cls,
        name: str,
        password: str,
        mnemonic: str | None = None,
        mnemonic_passphrase: str = "",
        _fast_kdf: bool = False,
    ) -> tuple["Wallet", str]:
        """New wallet from a (possibly fresh) BIP-39 mnemonic. Returns
        (wallet, mnemonic) — the caller shows the phrase exactly once."""
        from .bip39 import generate_mnemonic, mnemonic_to_seed

        if mnemonic is None:
            mnemonic = generate_mnemonic(256)
        seed = mnemonic_to_seed(mnemonic, mnemonic_passphrase)
        return (
            cls.create(name, password, seed=seed, _fast_kdf=_fast_kdf),
            mnemonic,
        )

    @classmethod
    def recover(
        cls,
        name: str,
        password: str,
        mnemonic: str,
        mnemonic_passphrase: str = "",
        _fast_kdf: bool = False,
    ) -> "Wallet":
        """Rebuild a wallet from its mnemonic — same seed, so the same
        EIP-2334 account derivations come back out."""
        w, _ = cls.create_with_mnemonic(
            name,
            password,
            mnemonic=mnemonic,
            mnemonic_passphrase=mnemonic_passphrase,
            _fast_kdf=_fast_kdf,
        )
        return w
