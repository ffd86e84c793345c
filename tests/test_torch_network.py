"""Port nodes and JAX nodes on one network over loopback TCP.

A JAX node and a port node from one interop genesis (both harnesses make
the same chain under `fake_crypto`): the Status handshake both ways; the
port importing the JAX node's gossip blocks and attestations with equal
head and state roots; range sync each way; blocks served by range and by
root with equal bytes; a port node booted from a JAX node's finalized
checkpoint over its Beacon API that backfills to genesis from it; a bad
block that lowers its sender's score equally with a port and a JAX
receiver; and a port node that finds a JAX node through a JAX boot
node."""

import time
from dataclasses import replace
from types import SimpleNamespace

import pytest

import lighthouse_tpu.beacon_chain.harness as j_harness
import lighthouse_tpu.crypto.bls as j_bls
import lighthouse_tpu.network as j_network
import lighthouse_tpu.network.discovery as j_discovery
import lighthouse_tpu.network.rpc as j_rpc
import lighthouse_tpu.types.chain_spec as j_spec
import lighthouse_tpu.types.eth_spec as j_eth
import lighthouse_tpu_torch.beacon_chain.harness as p_harness
import lighthouse_tpu_torch.crypto.bls as p_bls
import lighthouse_tpu_torch.network as p_network
import lighthouse_tpu_torch.network.discovery as p_discovery
import lighthouse_tpu_torch.network.rpc as p_rpc
import lighthouse_tpu_torch.types.chain_spec as p_spec
import lighthouse_tpu_torch.types.eth_spec as p_eth
from lighthouse_tpu.http_api import HttpApiServer as JHttpApiServer
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.client import ClientBuilder, ClientConfig

JAX = SimpleNamespace(name="jax", harness=j_harness, network=j_network, rpc=j_rpc, spec=j_spec, E=j_eth.MinimalEthSpec)
PORT = SimpleNamespace(name="port", harness=p_harness, network=p_network, rpc=p_rpc, spec=p_spec, E=p_eth.MinimalEthSpec)
SIDES = {"jax": JAX, "port": PORT}


@pytest.fixture(autouse=True)
def cpu_device():
    prev = default_device(), j_bls.backend_name(), p_bls.backend_setting()
    set_default_device("cpu")
    j_bls.set_backend("fake_crypto")
    p_bls.set_backend("fake_crypto")
    yield
    set_default_device(prev[0])
    j_bls.set_backend(prev[1])
    p_bls.set_backend(prev[2])


def _harness(side, slots=0, attest=False):
    h = side.harness.BeaconChainHarness(replace(side.spec.minimal_spec(), altair_fork_epoch=0), side.E, validator_count=16)
    if slots:
        h.extend_chain(slots, attest=attest)
    return h


def _wait(cond, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


def _stop(*services):
    for s in services:
        s.stop()


def test_status_handshake_both_ways():
    a, b = _harness(JAX, 8), _harness(PORT, 8)
    na, nb = JAX.network.NetworkService(a.chain).start(), PORT.network.NetworkService(b.chain).start()
    try:
        assert nb.local_status().serialize() == na.local_status().serialize()
        peer_a = nb.connect("127.0.0.1", na.port)
        peer_b = na.connect("127.0.0.1", nb.port)
        assert peer_a.status.serialize() == na.local_status().serialize()
        assert peer_b.status.serialize() == nb.local_status().serialize()
        assert nb.fork_digest() == na.fork_digest()
        assert _wait(lambda: len(na.peers.peers()) == 1 and len(nb.peers.peers()) == 1)
    finally:
        _stop(nb, na)


def test_port_imports_jax_gossip_blocks_and_attestations():
    a, b = _harness(JAX, 8), _harness(PORT)
    na, nb = JAX.network.NetworkService(a.chain).start(), PORT.network.NetworkService(b.chain).start()
    try:
        b.slot_clock.set_slot(a.chain.head_state.slot)
        peer = nb.connect("127.0.0.1", na.port)
        assert nb.sync.sync_with(peer) == 8
        topic = na.topic_block
        assert _wait(lambda: f"127.0.0.1:{nb.port}" in na.gossip.behaviour._subscribed_peers(topic))
        pooled = b.chain.op_pool.num_attestations()
        for slot in range(9, 13):
            a.slot_clock.set_slot(slot)
            b.slot_clock.set_slot(slot)
            root, signed = a.add_block_at_slot(slot)
            na.publish_block(signed)
            assert _wait(lambda: bytes(b.chain.head_root) == bytes(root)), slot
            assert b.chain.head_state.hash_tree_root() == a.chain.head_state.hash_tree_root()
            atts = a.make_unaggregated_attestations(slot, root)
            a.chain.process_attestation_batch(atts)
            for att in atts:
                na.publish_attestation(att)
            assert _wait(lambda: b.chain.op_pool.num_attestations() > pooled), slot
            pooled = b.chain.op_pool.num_attestations()
        assert bytes(b.chain.head_root) == bytes(a.chain.head_root)
        assert b.chain.head_state.serialize() == a.chain.head_state.serialize()
    finally:
        _stop(nb, na)


@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax")])
def test_range_sync_each_way(server, client):
    a, b = _harness(SIDES[server], 16), _harness(SIDES[client])
    na = SIDES[server].network.NetworkService(a.chain).start()
    nb = SIDES[client].network.NetworkService(b.chain).start()
    try:
        b.slot_clock.set_slot(a.chain.head_state.slot)
        peer = nb.connect("127.0.0.1", na.port)
        assert nb.sync.sync_with(peer) == 16
        assert bytes(b.chain.head_root) == bytes(a.chain.head_root)
        assert b.chain.head_state.hash_tree_root() == a.chain.head_state.hash_tree_root()
    finally:
        _stop(nb, na)


@pytest.mark.parametrize("asker", ["jax", "port"])
def test_blocks_served_by_range_and_root_with_equal_bytes(asker):
    a, b = _harness(JAX, 10), _harness(PORT, 10)
    na, nb = JAX.network.NetworkService(a.chain).start(), PORT.network.NetworkService(b.chain).start()
    rpc = SIDES[asker].rpc
    decode = (na if asker == "jax" else nb).decode_block
    try:
        got = {}
        for name, node in (("jax", na), ("port", nb)):
            client = rpc.RpcClient("127.0.0.1", node.port)
            blocks = client.blocks_by_range(1, 10, decode)
            roots = [blk.message.hash_tree_root() for blk in blocks[::3]]
            by_root = client.blocks_by_root(roots + [b"\x07" * 32], decode)
            got[name] = ([blk.serialize() for blk in blocks], [blk.serialize() for blk in by_root])
        assert got["port"] == got["jax"]
        assert len(got["jax"][0]) == 10 and len(got["jax"][1]) == 4
    finally:
        _stop(nb, na)


def test_checkpoint_boot_from_a_jax_node_and_backfill():
    a = _harness(JAX, 4 * 8, attest=True)
    assert a.finalized_epoch >= 2
    na = JAX.network.NetworkService(a.chain).start()
    api = JHttpApiServer(a.chain, port=0).start()
    cfg = ClientConfig(
        spec=replace(PORT.spec.minimal_spec(), altair_fork_epoch=0), E=PORT.E, validator_count=16,
        manual_slot_clock=True, http_port=None, network_port=0, sync_service_interval=None,
        checkpoint_sync_url=f"http://127.0.0.1:{api.port}",
    )
    d = ClientBuilder(cfg).build().start()
    try:
        assert bytes(d.chain.genesis_block_root) == bytes(a.chain.finalized_checkpoint.root)
        anchor = d.chain._blocks_by_root[bytes(d.chain.genesis_block_root)]
        d.slot_clock.set_slot(a.chain.head_state.slot)
        peer = d.network.connect("127.0.0.1", na.port)
        d.network.sync.sync_with(peer)
        assert bytes(d.chain.head_root) == bytes(a.chain.head_root)
        stored = d.network.sync.backfill(peer)
        assert stored == int(anchor.message.slot) - 1
        r, oldest = bytes(anchor.message.parent_root), None
        while (blk := d.chain.store.get_block(r)) is not None:
            served = a.chain._blocks_by_root.get(r) or a.chain.store.get_block(r)
            assert blk.serialize() == served.serialize()
            oldest, r = blk, bytes(blk.message.parent_root)
        assert int(oldest.message.slot) == 1
        assert r == bytes(a.chain.genesis_block_root)
    finally:
        _stop(d, api, na)


def _bad_block(h, slot):
    """A block of the JAX harness at `slot`, signed by its proposer, whose
    state root is not its post-state's."""
    from lighthouse_tpu.state_processing import per_slot_processing
    from lighthouse_tpu.state_processing.accessors import get_beacon_proposer_index

    st = h.chain.head_state.copy()
    while st.slot < slot:
        per_slot_processing(st, h.spec, h.E)
    proposer = get_beacon_proposer_index(st, h.E)
    parent = bytes(h.chain.head_root)
    block, _ = h.chain.produce_block_on_state(
        slot, h.randao_reveal(proposer, slot, st), sync_aggregate_fn=lambda s: h.make_sync_aggregate(s, slot, parent)
    )
    block.state_root = b"\x66" * 32
    return h.sign_block(block, st)


def test_bad_block_lowers_the_senders_score_equally():
    a = _harness(JAX, 8)
    receivers = {name: _harness(side, 8) for name, side in SIDES.items()}
    na = JAX.network.NetworkService(a.chain).start()
    nodes = {name: SIDES[name].network.NetworkService(h.chain).start() for name, h in receivers.items()}
    try:
        a_id = f"127.0.0.1:{na.port}"
        for name, node in nodes.items():
            node.connect("127.0.0.1", na.port)
        assert _wait(lambda: all(f"127.0.0.1:{n.port}" in na.gossip.behaviour._subscribed_peers(na.topic_block) for n in nodes.values()))
        slot = 9
        for h in (a, *receivers.values()):
            h.slot_clock.set_slot(slot)
        bad = _bad_block(a, slot)
        before = {name: (node.peers.get(a_id).score,) for name, node in nodes.items()}
        heads = {name: bytes(h.chain.head_root) for name, h in receivers.items()}
        na.publish_block(bad)
        ok = _wait(lambda: all(node.peers.get(a_id).score < before[name][0] for name, node in nodes.items()))
        after = {name: (node.peers.get(a_id).score,) for name, node in nodes.items()}
        assert ok, (before, after)
        # the peer manager's penalty is the same, one invalid message's;
        # the gossipsub score decays every heartbeat, so its invalid
        # deliveries are compared as counted, not as a total
        deltas = {name: after[name][0] - before[name][0] for name in nodes}
        assert deltas["port"] == deltas["jax"] == p_network.SCORE_INVALID_MESSAGE == j_network.SCORE_INVALID_MESSAGE
        invalid = {
            name: node.gossip.behaviour.score._peers[a_id].topics[node.topic_block].invalid_message_deliveries
            for name, node in nodes.items()
        }
        assert all(v > 0 for v in invalid.values()), invalid
        assert {name: bytes(h.chain.head_root) for name, h in receivers.items()} == heads
    finally:
        _stop(*nodes.values(), na)


def test_port_node_discovers_a_jax_node_through_a_jax_boot_node():
    a, b = _harness(JAX, 4), _harness(PORT, 4)
    boot = j_discovery.BootNode().start()
    enr = boot.enr()
    na = JAX.network.NetworkService(a.chain, bootnodes=[enr]).start()
    nb = PORT.network.NetworkService(b.chain, bootnodes=[p_discovery.Enr.from_dict(enr.to_dict())]).start()
    try:
        na.discovery.discover()  # registers the JAX node at the boot node
        assert nb.discover_and_connect() == 1
        assert [p.port for p in nb.peers.peers()] == [na.port]
        assert _wait(lambda: len(na.peers.peers()) == 1)
    finally:
        _stop(nb, na, boot)
