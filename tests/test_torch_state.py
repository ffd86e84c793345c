"""A seeded Deneb BeaconState carried from lighthouse_tpu into
lighthouse_tpu_torch through its SSZ bytes (types/convert.state_from_ssz):
equal bytes and equal hash_tree_root, cold and after the same block-sized
mutations, on the minimal and the mainnet preset. 4,096 validators put the
registry (and on mainnet the 65,536 randao_mixes) past the 2048-chunk
kernel thresholds, so the port's roots run through its kernel's plain
version here."""

import numpy as np
import pytest

import lighthouse_tpu.types as jax_types
import lighthouse_tpu_torch.types as port_types
from chip_smoke import block_update, build_deneb_state, host_state_root
from lighthouse_tpu.beacon_chain.chain import _make_persistent as jax_make_persistent
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.beacon_chain.chain import _make_persistent
from lighthouse_tpu_torch.ops import sha256 as port_sha
from lighthouse_tpu_torch.types.convert import state_from_ssz

N_VALIDATORS = 4096


@pytest.fixture(autouse=True)
def cpu_device():
    prev = default_device()
    set_default_device("cpu")
    yield
    set_default_device(prev)


@pytest.mark.parametrize("preset", ["minimal", "mainnet"])
def test_deneb_state_roots_match_jax(preset):
    JE = jax_types.preset_from_name(preset)
    PE = port_types.preset_from_name(preset)
    js = build_deneb_state(jax_types.build_types(JE), JE, N_VALIDATORS, seed=11)
    data = js.serialize()
    ps = state_from_ssz(data, "deneb", PE)
    assert type(ps) is port_types.build_types(PE).types_for_fork("deneb").BeaconState
    assert ps.serialize() == data

    jax_make_persistent(js)
    _make_persistent(ps)
    counts = dict(port_sha.COUNTS)
    cold = ps.hash_tree_root()
    assert cold == js.hash_tree_root()
    assert cold == host_state_root(ps)
    assert port_sha.COUNTS == counts  # the CPU device never launches

    jrng, prng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        block_update(js, JE, jrng)
        block_update(ps, PE, prng)
        root = ps.hash_tree_root()
        assert root == js.hash_tree_root()
        fresh = ps.copy()
        fresh.__dict__.pop("_thc_cache")
        assert fresh.hash_tree_root() == root
    assert ps.serialize() == js.serialize()
    assert state_from_ssz(js.serialize(), "deneb", PE).hash_tree_root() == root


def test_state_from_ssz_rejects_other_fork_bytes():
    JE = jax_types.preset_from_name("minimal")
    js = build_deneb_state(jax_types.build_types(JE), JE, 64, seed=2)
    with pytest.raises(Exception):
        state_from_ssz(js.serialize(), "phase0", port_types.preset_from_name("minimal"))
