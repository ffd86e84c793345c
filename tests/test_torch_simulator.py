"""The port's in-process simulator (`lighthouse_tpu_torch.testing.simulator`)
held to the JAX package's, under `fake_crypto` on the minimal preset.

`run_basic_sim` (2 nodes, 4 epochs) and `run_fallback_sim` (a node killed at
epoch 2, its VC failing over) finalize in the port, and the finalized and
justified epochs, the head slot and every check of the runs equal the JAX
package's. The roots are not compared: two runs of either package end on
different finalized and head roots, because which attestations a block
packs depends on when gossip reaches each node. The nodes are threads of one
process: a run never forks."""

import os

import pytest

import lighthouse_tpu.crypto.bls as j_bls
import lighthouse_tpu.testing.simulator as j_sim
import lighthouse_tpu.types.chain_spec as j_spec
import lighthouse_tpu.types.eth_spec as j_eth
import lighthouse_tpu_torch.crypto.bls as p_bls
import lighthouse_tpu_torch.testing.simulator as p_sim
import lighthouse_tpu_torch.types.chain_spec as p_spec
import lighthouse_tpu_torch.types.eth_spec as p_eth
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.validator_client.beacon_node_fallback import AllNodesFailed, BeaconNodeFallback, CandidateHealth

SIDES = {"jax": (j_sim, j_spec, j_eth.MinimalEthSpec), "port": (p_sim, p_spec, p_eth.MinimalEthSpec)}
SPE = 8


@pytest.fixture(autouse=True)
def fake_crypto():
    prev = default_device(), j_bls.backend_name(), p_bls.backend_setting()
    set_default_device("cpu")
    j_bls.set_backend("fake_crypto")
    p_bls.set_backend("fake_crypto")
    yield
    set_default_device(prev[0])
    j_bls.set_backend(prev[1])
    p_bls.set_backend(prev[2])


def _outcome(net, node=0):
    chain = net.nodes[node].chain
    return {
        "finalized_epoch": int(chain.finalized_checkpoint.epoch),
        "justified_epoch": int(chain.head_state.current_justified_checkpoint.epoch),
        "head_slot": int(chain.head_state.slot),
        "heads": len({bytes(n.chain.head_root) for n in net.live_nodes()}),
    }


def test_basic_sim_finalizes_as_in_the_jax_package():
    out = {}
    for name, (sim, spec, E) in SIDES.items():
        net = sim.run_basic_sim(spec.minimal_spec(), E, node_count=2, epochs=4)
        try:
            out[name] = _outcome(net)
        finally:
            net.shutdown()
    assert out["port"] == out["jax"]
    assert out["port"] == {"finalized_epoch": 2, "justified_epoch": 3, "head_slot": 4 * SPE, "heads": 1}


def test_fallback_sim_survives_bn_death_as_in_the_jax_package():
    out = {}
    for name, (sim, spec, E) in SIDES.items():
        net = sim.run_fallback_sim(spec.minimal_spec(), E, epochs=5, kill_at_epoch=2)
        try:
            dead_vc = net.nodes[1].vc
            health = {c.name: c.health.name for c in dead_vc.node.candidates}
            out[name] = (_outcome(net), type(dead_vc.node).__name__, health, net.nodes[1].interface.offline)
        finally:
            net.shutdown()
    assert out["port"] == out["jax"]
    outcome, fallback, health, offline = out["port"]
    assert outcome["finalized_epoch"] >= 2 and outcome["head_slot"] == 5 * SPE and offline
    assert fallback == "BeaconNodeFallback" and "ONLINE" in health.values()


def test_simulator_nodes_are_threads_that_never_fork(monkeypatch):
    """A CUDA context does not survive fork: the port's nodes run as
    threads of the one process."""

    def no_fork():
        raise AssertionError("the simulator forked")

    monkeypatch.setattr(os, "fork", no_fork)
    net = p_sim.LocalNetwork.create(p_spec.minimal_spec(), p_eth.MinimalEthSpec, 2, 16)
    try:
        net.run_until_slot(SPE + 1)
        net.check_all_heads_equal()
        assert _outcome(net)["head_slot"] == SPE + 1
    finally:
        net.shutdown()


class _FlakyNode:
    def __init__(self):
        self.up = True
        self.calls = 0

    def head_root(self):
        self.calls += 1
        if not self.up:
            raise ConnectionError("down")
        return b"\x11" * 32


def test_beacon_node_fallback_first_success_and_recovery():
    a, b = _FlakyNode(), _FlakyNode()
    fb = BeaconNodeFallback([a, b], recheck_interval=0.0)
    assert fb.head_root() == b"\x11" * 32 and (a.calls, b.calls) == (1, 0)
    a.up = False
    assert fb.head_root() == b"\x11" * 32
    assert fb.candidates[0].health is CandidateHealth.OFFLINE
    a.up = True
    fb.head_root()
    assert fb.candidates[0].health is CandidateHealth.ONLINE
    a.up = b.up = False
    with pytest.raises(AllNodesFailed):
        fb.head_root()
