"""The port's checkpoint sync and Beacon API client
(beacon_chain/checkpoint_sync.py, eth2/__init__.py) against the JAX
package, each booting node B from its own package's server.

Minimal preset with Altair from genesis, 64 interop validators,
`fake_crypto`, the CPU device. Node A: a harness extended 32 slots
(finalized epoch 2) behind `HttpApiServer` on 127.0.0.1, port 0. Node B:
`checkpoint_boot(url, HotColdDB(MemoryStore()), ...)` with a
`ManualSlotClock`; its anchor slot, anchor root, head and checkpoints
equal across the packages and equal to A's finalized checkpoint. Then A's
blocks past the anchor and its next 16 are POSTed to B's own API through
the package's `BeaconNodeHttpClient`, and B's head and finalized
checkpoint follow A's, alike. Refusals, class and message equal: a served state with one byte
changed (`CheckpointSyncError`), a served block that is not the advertised
one, a peer that has not finalized, and a weak-subjectivity root that
does not match (`BeaconChainError`).
"""

from dataclasses import replace
from types import SimpleNamespace

import pytest

from lighthouse_tpu import eth2 as jax_eth2
from lighthouse_tpu.beacon_chain import checkpoint_sync as jax_cs
from lighthouse_tpu.beacon_chain import harness as jax_harness
from lighthouse_tpu.beacon_chain.chain import BeaconChain as JaxChain
from lighthouse_tpu.crypto import bls as jax_bls
from lighthouse_tpu.http_api import HttpApiServer as JaxServer
from lighthouse_tpu.store import HotColdDB as JaxDB
from lighthouse_tpu.store import MemoryStore as JaxMem
from lighthouse_tpu.types import MinimalEthSpec as JaxE
from lighthouse_tpu.types import minimal_spec as jax_minimal_spec
from lighthouse_tpu.utils.slot_clock import ManualSlotClock as JaxClock
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch import eth2 as port_eth2
from lighthouse_tpu_torch.beacon_chain import checkpoint_sync as port_cs
from lighthouse_tpu_torch.beacon_chain import harness as port_harness
from lighthouse_tpu_torch.beacon_chain.chain import BeaconChain as PortChain
from lighthouse_tpu_torch.crypto import bls as port_bls
from lighthouse_tpu_torch.http_api import HttpApiServer as PortServer
from lighthouse_tpu_torch.store import HotColdDB as PortDB
from lighthouse_tpu_torch.store import MemoryStore as PortMem
from lighthouse_tpu_torch.types import MinimalEthSpec as PortE
from lighthouse_tpu_torch.types import minimal_spec as port_minimal_spec
from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock as PortClock

N_VALIDATORS = 64
SLOTS = 32
FOLLOW = 16

JAX = SimpleNamespace(
    name="jax", eth2=jax_eth2, cs=jax_cs, harness=jax_harness, Chain=JaxChain, Server=JaxServer,
    DB=JaxDB, Mem=JaxMem, Clock=JaxClock, E=JaxE, spec=jax_minimal_spec,
)
PORT = SimpleNamespace(
    name="port", eth2=port_eth2, cs=port_cs, harness=port_harness, Chain=PortChain, Server=PortServer,
    DB=PortDB, Mem=PortMem, Clock=PortClock, E=PortE, spec=port_minimal_spec,
)
SIDES = (JAX, PORT)


@pytest.fixture(autouse=True)
def fake_crypto():
    prev = default_device(), jax_bls.backend_name(), port_bls.backend_setting()
    set_default_device("cpu")
    jax_bls.set_backend("fake_crypto")
    port_bls.set_backend("fake_crypto")
    yield
    set_default_device(prev[0])
    jax_bls.set_backend(prev[1])
    port_bls.set_backend(prev[2])


def _source(side, slots=SLOTS):
    h = side.harness.BeaconChainHarness(replace(side.spec(), altair_fork_epoch=0), side.E, validator_count=N_VALIDATORS)
    h.extend_chain(slots)
    return h


def _url(srv):
    return f"http://127.0.0.1:{srv.port}"


def _cp(cp):
    return int(cp.epoch), bytes(cp.root)


def _boot(side, h, srv):
    clock = side.Clock(genesis_time=int(h.chain.head_state.genesis_time), seconds_per_slot=h.spec.seconds_per_slot)
    return side.cs.checkpoint_boot(_url(srv), side.DB(side.Mem()), h.spec, side.E, slot_clock=clock)


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class and message are compared
        return type(e).__name__, str(e)
    return None


def _boot_and_follow(side):
    h = _source(side)
    srv = side.Server(h.chain).start()
    try:
        b = _boot(side, h, srv)
        fin = _cp(h.chain.finalized_checkpoint)
        anchor = (
            int(b.anchor_slot),
            bytes(b.head_root),
            bytes(b.genesis_block_root),
            bytes(b.head_state.hash_tree_root()),
            _cp(b.justified_checkpoint),
            _cp(b.finalized_checkpoint),
        )
        assert anchor[1] == fin[1]
        b_srv = side.Server(b).start()
        try:
            client = side.eth2.BeaconNodeHttpClient(_url(b_srv))
            # A's blocks past the anchor, then its next FOLLOW blocks
            chain, root, behind = h.chain, bytes(h.chain.head_root), []
            while root != anchor[1]:
                behind.append(chain._blocks_by_root[root])
                root = bytes(behind[-1].message.parent_root)
            ahead = (chain._blocks_by_root[r] for r in (h.extend_chain(1)[0] for _ in range(FOLLOW)))
            codes = []
            for signed in [*reversed(behind), *ahead]:
                b.slot_clock.set_slot(int(signed.message.slot))
                codes.append(client.publish_block_ssz(signed.serialize()))
            followed = (
                bytes(b.head_root) == bytes(h.chain.head_root),
                _cp(b.finalized_checkpoint) == _cp(h.chain.finalized_checkpoint),
                client.get_state_root("head") == bytes(h.chain.head_state.hash_tree_root()),
            )
            after = (
                bytes(b.head_root),
                _cp(b.justified_checkpoint),
                _cp(b.finalized_checkpoint),
                client.get_finality_checkpoints("head"),
                client.get_block_ssz("head"),
            )
        finally:
            b_srv.stop()
    finally:
        srv.stop()
    return {"anchor": anchor, "source_finalized": fin, "codes": codes, "followed": followed, "after": after}


@pytest.fixture(scope="module")
def boots():
    prev = default_device(), jax_bls.backend_name(), port_bls.backend_setting()
    set_default_device("cpu")
    jax_bls.set_backend("fake_crypto")
    port_bls.set_backend("fake_crypto")
    try:
        return {side.name: _boot_and_follow(side) for side in SIDES}
    finally:
        set_default_device(prev[0])
        jax_bls.set_backend(prev[1])
        port_bls.set_backend(prev[2])


def test_boot_anchor_equal(boots):
    assert boots["port"]["anchor"] == boots["jax"]["anchor"]
    assert boots["port"]["source_finalized"] == boots["jax"]["source_finalized"]
    slot, head, _, _, _, fin = boots["port"]["anchor"]
    assert fin[0] >= 1 and head == boots["port"]["source_finalized"][1] and slot > 0


def test_blocks_posted_to_b_equal(boots):
    codes = boots["port"]["codes"]
    assert codes == boots["jax"]["codes"] and len(codes) > FOLLOW and set(codes) == {200}


def test_b_follows_head_and_finality_alike(boots):
    assert boots["port"]["after"] == boots["jax"]["after"]
    assert boots["port"]["followed"] == boots["jax"]["followed"] == (True, True, True)


def _refusals(side):
    h = _source(side)
    srv = side.Server(h.chain).start()
    api = srv.api
    out = {}
    try:
        url = _url(srv)
        served_state = api.debug_state_ssz
        served_block = api.block_ssz

        def one_byte_changed(state_id):
            data = bytearray(served_state(state_id))
            data[-1] ^= 1  # the last inactivity score: still decodes
            return bytes(data)

        api.debug_state_ssz = one_byte_changed
        out["state_byte"] = _error(lambda: side.cs.fetch_finalized_checkpoint(url, side.E))
        api.debug_state_ssz = served_state
        api.block_ssz = lambda block_id: served_block("head")
        out["other_block"] = _error(lambda: side.cs.fetch_finalized_checkpoint(url, side.E))
        api.block_ssz = served_block
        data = side.cs.fetch_finalized_checkpoint(url, side.E)
        out["fetched"] = (bytes(data.block_root), int(data.finalized_epoch), data.state.serialize())
        clock = side.Clock(genesis_time=int(data.state.genesis_time), seconds_per_slot=12)
        out["wss"] = _error(
            lambda: side.Chain.from_checkpoint(side.DB(side.Mem()), data.state, data.block, h.spec, side.E, clock, wss_checkpoint=b"\x13" * 32)
        )
    finally:
        srv.stop()
    young = _source(side, 2)
    srv = side.Server(young.chain).start()
    try:
        err = _error(lambda: side.cs.fetch_finalized_checkpoint(_url(srv), side.E))
        out["not_finalized"] = (err[0], err[1].replace(_url(srv), "URL"))
    finally:
        srv.stop()
    return out


def test_refusals_equal():
    jax_out, port_out = _refusals(JAX), _refusals(PORT)
    assert port_out == jax_out
    assert port_out["state_byte"][0] == "CheckpointSyncError" and "state root" in port_out["state_byte"][1]
    assert port_out["other_block"][0] == "CheckpointSyncError"
    assert port_out["not_finalized"][0] == "CheckpointSyncError"
    assert port_out["wss"][0] == "BeaconChainError"
