"""The port's eth1 follower and eth1 genesis service held to the JAX
package's: the same provider script (interop deposits, mined blocks) in both
packages gives equal deposit roots and proofs, equal `eth1_data_for_voting`
and deposits for a block, and an equal genesis state (bytes and root); a
deposit with a bad signature is skipped in both."""

from dataclasses import replace
from types import SimpleNamespace

import pytest

import lighthouse_tpu.crypto.bls as j_bls
import lighthouse_tpu.eth1 as j_eth1
import lighthouse_tpu.state_processing as j_sp
import lighthouse_tpu.state_processing.genesis as j_genesis
import lighthouse_tpu.types.chain_spec as j_spec
import lighthouse_tpu.types.containers as j_types
import lighthouse_tpu.types.eth_spec as j_eth
import lighthouse_tpu_torch.crypto.bls as p_bls
import lighthouse_tpu_torch.eth1 as p_eth1
import lighthouse_tpu_torch.state_processing as p_sp
import lighthouse_tpu_torch.state_processing.genesis as p_genesis
import lighthouse_tpu_torch.types.chain_spec as p_spec
import lighthouse_tpu_torch.types.containers as p_types
import lighthouse_tpu_torch.types.eth_spec as p_eth
from lighthouse_tpu_torch import default_device, set_default_device

SIDES = {
    name: SimpleNamespace(bls=b, eth1=e, sp=sp, genesis=g, spec=s, types=t.build_types(m.MinimalEthSpec), E=m.MinimalEthSpec)
    for name, b, e, sp, g, s, t, m in (
        ("jax", j_bls, j_eth1, j_sp, j_genesis, j_spec, j_types, j_eth),
        ("port", p_bls, p_eth1, p_sp, p_genesis, p_spec, p_types, p_eth),
    )
}
AMOUNT = 32_000_000_000


@pytest.fixture(autouse=True)
def backends():
    prev = default_device(), j_bls.backend_name(), p_bls.backend_setting()
    set_default_device("cpu")
    yield
    set_default_device(prev[0])
    j_bls.set_backend(prev[1])
    p_bls.set_backend(prev[2])


def _crypto(real: bool):
    j_bls.set_backend("host" if real else "fake_crypto")
    p_bls.set_backend("host" if real else "fake_crypto")


def _spec(side, **kw):
    return replace(
        side.spec.minimal_spec(),
        **{"min_genesis_active_validator_count": 4, "min_genesis_time": 1_500_000_000, "genesis_delay": 60, "eth1_follow_distance": 2, **kw},
    )


def _script(side, deposits=8, blocks=10, bad=None, **kw):
    """The provider script: `deposits` interop deposits (the one at `bad`
    signed over another message) and `blocks` mined blocks after them."""
    spec = _spec(side, **kw)
    provider = side.eth1.MockEth1Provider(spec)
    kps = side.bls.interop_keypairs(deposits + 1)
    for i, kp in enumerate(kps[:deposits]):
        d = side.genesis.build_deposit_data(kp, AMOUNT, spec, side.E)
        if i == bad:
            d.signature = side.genesis.build_deposit_data(kps[deposits], AMOUNT, spec, side.E).signature
        provider.submit_deposit(d)
    for _ in range(blocks):
        provider.mine_block()
    service = side.eth1.Eth1Service(provider, spec, side.E)
    service.update()
    return spec, provider, service


def _both(fn):
    out = {name: fn(side) for name, side in SIDES.items()}
    assert out["port"] == out["jax"]
    return out["jax"]


def test_deposit_roots_and_proofs_equal():
    _crypto(False)

    def run(side):
        _, _, service = _script(side)
        cache = service.deposit_cache
        return (
            [bytes(log.deposit_data.serialize()) for log in cache.logs],
            [cache.deposit_root(c) for c in range(1, 9)],
            [d.serialize() for d in cache.get_deposits(0, 8, 8)],
            [d.serialize() for d in cache.get_deposits(2, 5, 6)],
        )

    datas, roots, _, _ = _both(run)
    assert len(datas) == 8 and len(set(roots)) == 8


def test_a_non_contiguous_log_is_refused_in_both():
    _crypto(False)

    def run(side):
        _, _, service = _script(side, deposits=2)
        log = service.deposit_cache.logs[0]
        with pytest.raises(side.eth1.DepositCacheError):
            service.deposit_cache.insert_log(side.eth1.DepositLog(index=9, deposit_data=log.deposit_data, block_number=1))
        service.deposit_cache.insert_log(log)  # a replay is ignored
        with pytest.raises(side.eth1.DepositCacheError):
            service.deposit_cache.deposit_root(5)
        return len(service.deposit_cache.logs)

    assert _both(run) == 2


@pytest.mark.parametrize("votes", [0, 1, 3], ids=["no_votes", "one_vote", "majority"])
def test_eth1_data_for_voting_equal(votes):
    _crypto(False)

    def run(side):
        spec, provider, service = _script(side, deposits=4)
        state = side.sp.interop_genesis_state(side.bls.interop_keypairs(4), 2_000_000_000, b"\x42" * 32, spec, side.E)
        cand = service.eth1_data_for_voting(state)
        other = side.types.Eth1Data(deposit_root=b"\x07" * 32, deposit_count=4, block_hash=b"\x08" * 32)
        for i in range(votes):
            state.eth1_data_votes.append(cand if i % 2 == 0 else other)
        vote = service.eth1_data_for_voting(state)
        empty = side.eth1.Eth1Service(side.eth1.MockEth1Provider(spec), spec, side.E)
        return cand.serialize(), vote.serialize(), empty.eth1_data_for_voting(state) == state.eth1_data

    cand, vote, default = _both(run)
    assert cand == vote and default


def test_deposits_for_block_equal():
    _crypto(False)

    def run(side):
        spec, _, service = _script(side, deposits=6)
        state = side.sp.interop_genesis_state(side.bls.interop_keypairs(4), 2_000_000_000, b"\x42" * 32, spec, side.E)
        state.eth1_data = side.types.Eth1Data(deposit_root=service.deposit_cache.deposit_root(6), deposit_count=6, block_hash=b"\x01" * 32)
        state.eth1_deposit_index = 1
        return [d.serialize() for d in service.deposits_for_block(state)]

    assert len(_both(run)) == 5


def test_try_genesis_waits_for_the_criteria_in_both():
    _crypto(False)

    def run(side):
        spec, provider, service = _script(side, deposits=3, blocks=1)
        gs = side.eth1.Eth1GenesisService(service, spec, side.E)
        early = gs.try_genesis()
        provider.submit_deposit(side.genesis.build_deposit_data(side.bls.interop_keypairs(4)[3], AMOUNT, spec, side.E))
        provider.mine_block()
        state = gs.try_genesis()
        return early is None, state.serialize(), state.hash_tree_root()

    early, _, _ = _both(run)
    assert early


@pytest.mark.parametrize("bad", [None, 2], ids=["all_valid", "one_bad_signature"])
def test_genesis_state_equal(bad):
    """Host BLS: the deposits' signatures are verified in one batch; with a
    bad one the batch fails, each deposit is verified alone and the bad one
    is skipped (no validator), in both packages."""
    _crypto(True)

    def run(side):
        spec, provider, service = _script(side, deposits=6, blocks=1, bad=bad)
        state = side.eth1.Eth1GenesisService(service, spec, side.E).try_genesis()
        assert side.genesis.is_valid_genesis_state(state, spec, side.E)
        return (
            state.serialize(),
            state.hash_tree_root(),
            len(state.validators),
            bytes(state.eth1_data.deposit_root) == service.deposit_cache.deposit_root(),
            int(state.genesis_time) == provider._blocks[-1].timestamp + spec.genesis_delay,
        )

    _, _, validators, root_ok, time_ok = _both(run)
    assert validators == (6 if bad is None else 5) and root_ok and time_ok
