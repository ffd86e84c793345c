"""The port's watch (`lighthouse_tpu_torch.watch`) held to the JAX package's:
each package's WatchUpdater indexes the same harness chain (both harnesses
make the same chain under `fake_crypto`), served by its own package's Beacon
API over HTTP, into equal WatchDB rows, skipped slots included; blockprint
classifies the same block bytes alike; and the WatchServer routes answer
alike."""

import json
import urllib.error
import urllib.request
from dataclasses import replace
from types import SimpleNamespace

import pytest

import lighthouse_tpu.beacon_chain.harness as j_harness
import lighthouse_tpu.crypto.bls as j_bls
import lighthouse_tpu.eth2 as j_eth2
import lighthouse_tpu.http_api as j_api
import lighthouse_tpu.types.chain_spec as j_spec
import lighthouse_tpu.types.containers as j_types
import lighthouse_tpu.types.eth_spec as j_eth
import lighthouse_tpu.watch as j_watch
import lighthouse_tpu.watch.blockprint as j_bp
import lighthouse_tpu_torch.beacon_chain.harness as p_harness
import lighthouse_tpu_torch.crypto.bls as p_bls
import lighthouse_tpu_torch.eth2 as p_eth2
import lighthouse_tpu_torch.http_api as p_api
import lighthouse_tpu_torch.types.chain_spec as p_spec
import lighthouse_tpu_torch.types.containers as p_types
import lighthouse_tpu_torch.types.eth_spec as p_eth
import lighthouse_tpu_torch.watch as p_watch
import lighthouse_tpu_torch.watch.blockprint as p_bp
from lighthouse_tpu_torch import default_device, set_default_device

SIDES = {
    name: SimpleNamespace(harness=h, eth2=e, api=a, spec=s, types=t.build_types(m.MinimalEthSpec), E=m.MinimalEthSpec, watch=w, bp=bp)
    for name, h, e, a, s, t, m, w, bp in (
        ("jax", j_harness, j_eth2, j_api, j_spec, j_types, j_eth, j_watch, j_bp),
        ("port", p_harness, p_eth2, p_api, p_spec, p_types, p_eth, p_watch, p_bp),
    )
}
SLOTS = 8
ROUTES = ("/v1/slots/missed", "/v1/proposers", "/v1/finality", "/v1/packing", "/v1/gaps", "/v1/blockprint", "/v1/rewards", "/v1/nowhere")


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


def _rows(db) -> dict:
    """Every table of a WatchDB, in key order."""
    tables = ("canonical_slots", "finality", "gaps", "block_packing", "suboptimal_attestations", "blockprint", "block_rewards")
    with db._lock:
        return {t: db._conn.execute(f"SELECT * FROM {t} ORDER BY 1, 2").fetchall() for t in tables}


def _index(side) -> dict:
    """A harness chain of SLOTS slots, a skipped slot and one more block,
    indexed twice by watch over the side's own API server; then the
    WatchServer's answers."""
    spec = replace(side.spec.minimal_spec(), altair_fork_epoch=0)
    h = side.harness.BeaconChainHarness(spec, side.E, validator_count=16)
    h.extend_chain(SLOTS)
    server = side.api.HttpApiServer(h.chain).start()
    try:
        db = side.watch.WatchDB()
        updater = side.watch.WatchUpdater(side.eth2.BeaconNodeHttpClient(f"http://127.0.0.1:{server.port}"), db, side.types)
        first = updater.update()
        again = updater.update()
        skip_to = h.chain.head_state.slot + 2
        h.slot_clock.set_slot(skip_to)
        h.add_block_at_slot(skip_to)
        last = updater.update()
        ws = side.watch.WatchServer(db).start()
        try:
            answers = {}
            for route in ROUTES:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{ws.port}{route}", timeout=10) as r:
                        answers[route] = (r.status, json.loads(r.read()))
                except urllib.error.HTTPError as e:
                    answers[route] = (e.code, json.loads(e.read()))
        finally:
            ws.stop()
        return {
            "recorded": (first, again, last),
            "rows": _rows(db),
            "missed": db.missed_slots(),
            "proposers": db.proposer_counts(),
            "packing": db.packing_stats(),
            "rewards": db.rewards_stats(),
            "answers": answers,
            "skipped": skip_to - 1,
        }
    finally:
        server.stop()


@pytest.fixture(scope="module")
def indexed():
    prev = default_device(), j_bls.backend_name(), p_bls.backend_setting()
    set_default_device("cpu")
    j_bls.set_backend("fake_crypto")
    p_bls.set_backend("fake_crypto")
    try:
        return {name: _index(side) for name, side in SIDES.items()}
    finally:
        set_default_device(prev[0])
        j_bls.set_backend(prev[1])
        p_bls.set_backend(prev[2])


@pytest.mark.parametrize("key", ["recorded", "rows", "missed", "proposers", "packing", "rewards"])
def test_watch_db_equal(indexed, key):
    assert indexed["port"][key] == indexed["jax"][key]


def test_watch_recorded_the_chain(indexed):
    got = indexed["port"]
    assert got["recorded"] == (SLOTS, 0, 2)
    assert got["missed"] == [got["skipped"]]
    assert sum(got["proposers"].values()) == SLOTS + 1
    assert got["rewards"]["blocks"] == SLOTS + 1 and got["rewards"]["total_gwei"] > 0


@pytest.mark.parametrize("route", ROUTES)
def test_watch_server_answers_equal(indexed, route):
    assert indexed["port"]["answers"][route] == indexed["jax"]["answers"][route]
    assert indexed["port"]["answers"][route][0] == (404 if route == "/v1/nowhere" else 200)


GRAFFITI = [b"Lighthouse/v4.6.0", b"lighthouse-tpu/v0", b"teku/23.1", b"prysm-rc", b"Nimbus", b"lodestar", b"grandine", b"gm", b""]


@pytest.mark.parametrize("graffiti", GRAFFITI, ids=[g.decode() or "empty" for g in GRAFFITI])
@pytest.mark.parametrize("extra_data", [None, b"geth go1.21", b"Nethermind", b"reth", b"lighthouse"], ids=["phase0", "geth", "nethermind", "reth", "cl_in_el"])
def test_blockprint_equal_on_the_same_block_bytes(graffiti, extra_data):
    jt, pt = SIDES["jax"].types, SIDES["port"].types
    if extra_data is None:
        body = jt.BeaconBlockBody(graffiti=graffiti.ljust(32, b"\x00"))
        raw = jt.SignedBeaconBlock(message=jt.BeaconBlock(slot=1, body=body), signature=b"\x00" * 96).serialize()
        port_block, jax_block = pt.SignedBeaconBlock.deserialize(raw), jt.SignedBeaconBlock.deserialize(raw)
    else:
        body = jt.BeaconBlockBodyBellatrix(graffiti=graffiti.ljust(32, b"\x00"), execution_payload=jt.ExecutionPayload(extra_data=extra_data))
        raw = jt.SignedBeaconBlockBellatrix(message=jt.BeaconBlockBellatrix(slot=2, body=body), signature=b"\x00" * 96).serialize()
        port_block, jax_block = pt.SignedBeaconBlockBellatrix.deserialize(raw), jt.SignedBeaconBlockBellatrix.deserialize(raw)
    assert p_bp.classify_block(port_block) == j_bp.classify_block(jax_block)
