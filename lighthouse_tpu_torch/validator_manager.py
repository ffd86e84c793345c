"""Validator + account management (validator_manager / account_manager
analogs): create validators from an EIP-2333 seed (EIP-2334 paths), write
EIP-2335 keystores + deposit data, import/list keystores in a validator
directory. Driven by the `vm` CLI subcommands."""

from __future__ import annotations

import json
import os
import pathlib

import contextlib

from .crypto import bls
from .crypto.key_derivation import derive_sk_from_path, validator_keypair_path
from .crypto.keystore import Keystore


@contextlib.contextmanager
def _host_backend():
    """Key management needs real curve ops; restore the caller's backend
    setting after (mutating the process-global backend out from under a
    running chain breaks its verification; None goes back to following
    the device)."""
    prev = bls.backend_setting()
    bls.set_backend("host")
    try:
        yield
    finally:
        bls.set_backend(prev)


def create_validators(
    seed: bytes,
    count: int,
    out_dir: str | os.PathLike,
    password: str,
    first_index: int = 0,
    amount_gwei: int = 32_000_000_000,
    spec=None,
    E=None,
    fast_kdf: bool = False,
) -> list[dict]:
    """Derive `count` validators, write keystore-<pubkey>.json files and a
    deposit_data.json; returns the deposit-data records."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    records = []
    with _host_backend():
        _create_all(seed, count, out, password, first_index, amount_gwei,
                    spec, E, fast_kdf, records)
    with open(out / "deposit_data.json", "w") as f:
        json.dump(records, f, indent=2)
    return records


def _create_all(seed, count, out, password, first_index, amount_gwei, spec, E,
                fast_kdf, records):
    for i in range(first_index, first_index + count):
        path = validator_keypair_path(i, "signing")
        sk_int = derive_sk_from_path(seed, path)
        sk = bls.SecretKey(sk_int)
        pk = sk.public_key()
        ks = Keystore.encrypt(
            sk.to_bytes(), password, path=path, _fast_kdf=fast_kdf
        )
        ks.save(out / f"keystore-{pk.to_bytes().hex()[:16]}.json")
        record = {
            "pubkey": pk.to_bytes().hex(),
            "withdrawal_credentials": None,
            "amount": amount_gwei,
            "path": path,
        }
        if spec is not None and E is not None:
            from .state_processing.genesis import build_deposit_data

            class _KP:  # build_deposit_data takes a keypair-shaped object
                pass

            kp = _KP()
            kp.sk, kp.pk = sk, pk
            data = build_deposit_data(kp, amount_gwei, spec, E)
            record["withdrawal_credentials"] = bytes(
                data.withdrawal_credentials
            ).hex()
            record["signature"] = bytes(data.signature).hex()
            record["deposit_data_root"] = data.hash_tree_root().hex()
        records.append(record)


def list_validators(dir_path: str | os.PathLike) -> list[dict]:
    out = []
    for p in sorted(pathlib.Path(dir_path).glob("keystore-*.json")):
        ks = Keystore.load(p)
        out.append({"pubkey": ks.pubkey.hex(), "path": ks.path, "file": p.name})
    return out


def import_keystore(
    keystore_path: str | os.PathLike,
    password: str,
    validators_dir: str | os.PathLike,
) -> bytes:
    """Validate the password and copy the keystore into the validator dir
    (returns the pubkey)."""
    ks = Keystore.load(keystore_path)
    ks.decrypt(password)  # raises on wrong password
    dest = pathlib.Path(validators_dir)
    dest.mkdir(parents=True, exist_ok=True)
    ks.save(dest / f"keystore-{ks.pubkey.hex()[:16]}.json")
    return ks.pubkey


def load_signers(dir_path: str | os.PathLike, password: str):
    """Decrypt every keystore in a directory into (pubkey, SecretKey)
    pairs — what a VC start-up does."""
    out = []
    with _host_backend():
        for p in sorted(pathlib.Path(dir_path).glob("keystore-*.json")):
            ks = Keystore.load(p)
            secret = ks.decrypt(password)
            out.append((ks.pubkey, bls.SecretKey.from_bytes(secret)))
    return out
