"""The port's key material (crypto/{aes,bip39,key_derivation,keystore,
wallet}.py) against lighthouse_tpu's: seeded inputs through both
packages, compared exactly (bytes, integers, JSON documents, errors).
Keystores use pbkdf2 or scrypt with the small work factor `_fast_kdf`
(c = n = 2^10): the EIP-2335 defaults cost ~0.5 s and 256 MiB a key."""

import json
import os
import unicodedata
import uuid

import numpy as np
import pytest

from lighthouse_tpu.crypto import aes as jax_aes
from lighthouse_tpu.crypto import bls as jax_bls
from lighthouse_tpu.crypto import bip39 as jax_bip39
from lighthouse_tpu.crypto import key_derivation as jax_kd
from lighthouse_tpu.crypto import keystore as jax_ks
from lighthouse_tpu.crypto import wallet as jax_wallet
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.crypto import aes as port_aes
from lighthouse_tpu_torch.crypto import bls as port_bls
from lighthouse_tpu_torch.crypto import bip39 as port_bip39
from lighthouse_tpu_torch.crypto import key_derivation as port_kd
from lighthouse_tpu_torch.crypto import keystore as port_ks
from lighthouse_tpu_torch.crypto import wallet as port_wallet

PACKAGES = {"jax": (jax_aes, jax_bip39, jax_kd, jax_ks, jax_wallet), "port": (port_aes, port_bip39, port_kd, port_ks, port_wallet)}


@pytest.fixture(autouse=True)
def host_backends():
    """A keystore without a given pubkey takes its secret's public key
    from the active BLS backend: both packages on the host one, whatever
    an earlier test in the process left set."""
    prev = default_device(), jax_bls.backend_name(), port_bls.backend_setting()
    set_default_device("cpu")
    jax_bls.set_backend("host")
    port_bls.set_backend(None)  # follows the CPU device: host
    yield
    set_default_device(prev[0])
    jax_bls.set_backend(prev[1])
    port_bls.set_backend(prev[2])


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


@pytest.mark.parametrize("size", [0, 1, 15, 16, 17, 64, 1000])
def test_aes128_ctr_equals_the_jax_package(size):
    rng = _rng(size)
    key, iv, data = rng.bytes(16), rng.bytes(16), rng.bytes(size)
    got = port_aes.aes128_ctr(key, iv, data)
    assert got == jax_aes.aes128_ctr(key, iv, data)
    assert port_aes.aes128_ctr(key, iv, got) == data


def test_aes_counter_wraps_like_the_jax_package():
    key, iv, data = b"\x07" * 16, b"\xff" * 16, bytes(range(48))
    assert port_aes.aes128_ctr(key, iv, data) == jax_aes.aes128_ctr(key, iv, data)


@pytest.mark.parametrize("bits", [128, 160, 192, 224, 256])
def test_bip39_entropy_mnemonic_and_seed(bits):
    entropy = _rng(bits).bytes(bits // 8)
    mnemonic = port_bip39.entropy_to_mnemonic(entropy)
    assert mnemonic == jax_bip39.entropy_to_mnemonic(entropy)
    assert port_bip39.mnemonic_to_entropy(mnemonic) == entropy
    assert port_bip39.validate_mnemonic(mnemonic) and jax_bip39.validate_mnemonic(mnemonic)
    # a passphrase that NFKD changes: both normalize it the same way
    passphrase = "ｐａｓｓé"
    assert unicodedata.normalize("NFKD", passphrase) != passphrase
    assert port_bip39.mnemonic_to_seed(mnemonic, passphrase) == jax_bip39.mnemonic_to_seed(mnemonic, passphrase)
    assert port_bip39.generate_mnemonic(bits, entropy=entropy) == jax_bip39.generate_mnemonic(bits, entropy=entropy)


def test_bip39_refusals_agree():
    words = port_bip39.entropy_to_mnemonic(bytes(16)).split()
    bad_checksum = " ".join(words[:-1] + ["zoo"])
    for bad in (bad_checksum, "abandon " * 11 + "notaword", "abandon abandon"):
        for bip in (port_bip39, jax_bip39):
            assert not bip.validate_mnemonic(bad)
        with pytest.raises(port_bip39.Bip39Error):
            port_bip39.mnemonic_to_entropy(bad)
        with pytest.raises(jax_bip39.Bip39Error):
            jax_bip39.mnemonic_to_entropy(bad)


PATHS = ["m/12381/3600/0/0/0", "m/12381/3600/7/0", "m/12381/3600/123/0/0", "m/0", "m/12381/60/4294967295/1"]


@pytest.mark.parametrize("seed_index", range(4))
def test_eip2333_derive_sk_from_path(seed_index):
    seed = _rng(100 + seed_index).bytes(32 + 16 * seed_index)
    assert port_kd.derive_master_sk(seed) == jax_kd.derive_master_sk(seed)
    for path in PATHS:
        assert port_kd.derive_sk_from_path(seed, path) == jax_kd.derive_sk_from_path(seed, path)
    for index in (0, 1, 99):
        for kind in ("signing", "withdrawal"):
            assert port_kd.validator_keypair_path(index, kind) == jax_kd.validator_keypair_path(index, kind)


def test_eip2333_refuses_short_seeds_and_bad_paths_alike():
    for kd in (port_kd, jax_kd):
        with pytest.raises(ValueError):
            kd.derive_master_sk(b"\x01" * 31)
        with pytest.raises(ValueError):
            kd.derive_sk_from_path(b"\x01" * 32, "x/1/2")


class _Fixed:
    """os.urandom and uuid.uuid4 from a seed, reset for each package."""

    def __init__(self, seed: int):
        self.rng = _rng(seed)

    def urandom(self, n: int) -> bytes:
        return self.rng.bytes(n)

    def uuid4(self):
        return uuid.UUID(bytes=self.rng.bytes(16), version=4)


def _with_fixed_randomness(monkeypatch, seed: int, fn):
    fixed = _Fixed(seed)
    monkeypatch.setattr(os, "urandom", fixed.urandom)
    monkeypatch.setattr(uuid, "uuid4", fixed.uuid4)
    try:
        return fn()
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("kdf", ["pbkdf2", "scrypt"])
def test_eip2335_keystores_equal_and_cross_decrypt(monkeypatch, kdf):
    secret = (int.from_bytes(_rng(7).bytes(32), "big") % (2**254)).to_bytes(32, "big")
    pubkey = b"\xab" * 48
    password = "𝔱𝔢𝔰𝔱password\x7f"
    docs = {
        name: _with_fixed_randomness(
            monkeypatch,
            11,
            lambda ks=mods[3]: ks.Keystore.encrypt(
                secret, password, path="m/12381/3600/0/0/0", kdf=kdf, pubkey=pubkey, description="d", _fast_kdf=True
            ),
        )
        for name, mods in PACKAGES.items()
    }
    assert json.loads(docs["port"].to_json()) == json.loads(docs["jax"].to_json())
    # each decrypts the other's document
    assert port_ks.Keystore.from_json(docs["jax"].to_json()).decrypt(password) == secret
    assert jax_ks.Keystore.from_json(docs["port"].to_json()).decrypt(password) == secret
    # the wrong password: the same error from both
    with pytest.raises(port_ks.KeystoreError) as port_err:
        docs["port"].decrypt("wrong")
    with pytest.raises(jax_ks.KeystoreError) as jax_err:
        docs["jax"].decrypt("wrong")
    assert str(port_err.value) == str(jax_err.value)


def test_keystore_secret_length_and_kdf_refusals_agree():
    for ks in (port_ks, jax_ks):
        with pytest.raises(ks.KeystoreError, match="32 bytes"):
            ks.Keystore.encrypt(b"\x01" * 31, "pw", pubkey=b"\x02" * 48, _fast_kdf=True)
        with pytest.raises(ks.KeystoreError, match="unsupported kdf"):
            ks.Keystore.encrypt(b"\x01" * 32, "pw", pubkey=b"\x02" * 48, kdf="argon2")
        with pytest.raises(ks.KeystoreError):
            ks.Keystore.from_json(json.dumps({"version": 4}))


def test_wallet_next_keystores_equal(monkeypatch):
    seed = _rng(21).bytes(32)

    def run(wallet_mod):
        w = wallet_mod.Wallet.create("w", "wallet-pw", seed=seed, _fast_kdf=True)
        stores = [w.next_validator("wallet-pw", "ks-pw", _fast_kdf=True) for _ in range(2)]
        return w, stores

    out = {name: _with_fixed_randomness(monkeypatch, 5, lambda m=mods[4]: run(m)) for name, mods in PACKAGES.items()}
    (pw, pstores), (jw, jstores) = out["port"], out["jax"]
    assert json.loads(pw.to_json()) == json.loads(jw.to_json())
    assert pw.nextaccount == jw.nextaccount == 2
    for p, j in zip(pstores, jstores):
        assert json.loads(p.to_json()) == json.loads(j.to_json())
        assert p.path == j.path
        assert int.from_bytes(p.decrypt("ks-pw"), "big") == port_kd.derive_sk_from_path(seed, p.path)
    # each package's wallet recovers the seed from the other's document
    assert port_wallet.Wallet.from_json(jw.to_json()).decrypt_seed("wallet-pw") == seed
    assert jax_wallet.Wallet.from_json(pw.to_json()).decrypt_seed("wallet-pw") == seed


def test_wallet_from_mnemonic_equal(monkeypatch):
    entropy = _rng(33).bytes(32)
    mnemonic = port_bip39.entropy_to_mnemonic(entropy)

    def run(wallet_mod):
        w = wallet_mod.Wallet.recover("r", "pw", mnemonic, _fast_kdf=True)
        return w, w.next_validator("pw", "kpw", _fast_kdf=True)

    out = {name: _with_fixed_randomness(monkeypatch, 9, lambda m=mods[4]: run(m)) for name, mods in PACKAGES.items()}
    assert json.loads(out["port"][0].to_json()) == json.loads(out["jax"][0].to_json())
    assert json.loads(out["port"][1].to_json()) == json.loads(out["jax"][1].to_json())
