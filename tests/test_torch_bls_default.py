"""The port's BLS backend follows the default device until a caller
pins one: `host` on the CPU device, `cuda` on the `cuda` device (the JAX
package's `tpu` counterpart), whatever was set before; `set_backend(name)`
wins until `set_backend(None)`. With the device `cuda` and no card, the
first batch verify raises, also through the chain's own entry points;
nothing falls back to the host. Signing and single verifies stay the
host's on both."""

import random

import pytest
import torch

from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.beacon_chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.types import MinimalEthSpec, minimal_spec


@pytest.fixture(autouse=True)
def restore():
    prev = default_device(), bls.backend_setting()
    bls.set_backend(None)
    yield
    set_default_device(prev[0])
    bls.set_backend(prev[1])


@pytest.mark.parametrize("device, backend", [("cpu", "host"), ("cuda", "cuda")])
def test_backend_follows_the_device(device, backend):
    set_default_device(device)
    assert bls.backend_setting() is None
    assert bls.backend_name() == backend
    assert bls.get_backend() is bls._BACKENDS[backend]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", ["host", "fake_crypto", "cuda"])
def test_an_explicit_backend_wins_until_reset(device, name):
    set_default_device(device)
    bls.set_backend(name)
    assert bls.backend_setting() == name and bls.backend_name() == name
    set_default_device("cuda" if device == "cpu" else "cpu")
    assert bls.backend_name() == name
    bls.set_backend(None)
    assert bls.backend_name() == ("cuda" if device == "cpu" else "host")


def _sets(n: int = 2):
    sks = [bls.interop_secret_key(i) for i in range(n)]
    msgs = [bytes([i]) * 32 for i in range(n)]
    return [bls.SignatureSet.single(sk.sign(m), sk.public_key(), m) for sk, m in zip(sks, msgs)]


def test_the_cpu_device_verifies_on_the_host():
    set_default_device("cpu")
    sets = _sets()
    assert bls.verify_signature_sets(sets, random.Random(1))
    bad = [sets[0], bls.SignatureSet(sets[0].signature, sets[1].pubkeys, sets[1].message)]
    assert not bls.verify_signature_sets(bad, random.Random(1))


def test_a_cuda_verify_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    set_default_device("cpu")
    sets = _sets()  # signing is the host's on every backend
    set_default_device("cuda")
    assert bls.backend_name() == "cuda"
    assert sets[0].verify()  # a single verify is the host's
    with pytest.raises(RuntimeError, match="cuda"):
        bls.verify_signature_sets(sets, random.Random(1))


def test_the_chain_on_the_cuda_device_without_a_card_raises():
    """A harness built on the CPU, then driven with the device `cuda` and
    no set_backend call: the block import's bulk verify raises instead of
    verifying on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    set_default_device("cpu")
    h = BeaconChainHarness(minimal_spec(), MinimalEthSpec, validator_count=16)
    set_default_device("cuda")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        h.extend_chain(1)
    assert int(h.chain.head_state.slot) == 0
