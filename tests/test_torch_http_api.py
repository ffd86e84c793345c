"""The port's Beacon API (http_api/__init__.py, columnar.py,
response_cache.py, block_index.py) against the JAX package's over HTTP.

Both packages' `HttpApiServer` on 127.0.0.1, port 0, each over its own
package's harness, built alike: minimal preset with Altair from genesis,
64 interop validators, `fake_crypto`, the CPU device, 34 slots (justified
epoch 3, finalized 2), the head slot's attestations in the pool. Every
route of `_ROUTES` and of the handler's own matches is read from both
servers, with state and block ids of every kind, filters, SSZ and JSON,
and the error paths (400, 404); then POSTs: a block (SSZ), an attestation
list, an exit, aggregates, sync messages, proposer preparations, duties
and rewards, JSON where SSZ is required (415), bodies that do not decode
(400), an unknown route (404). Compared: status, Content-Type,
Eth-Consensus-Version and the body's bytes, the response cache's keys, and
the heads after each POST. Tolerance: byte equality. `node_version`
answers the JAX package's string on both sides.
"""

import json
import urllib.error
import urllib.request
from dataclasses import replace
from types import SimpleNamespace

import pytest

from lighthouse_tpu import state_processing as jax_sp
from lighthouse_tpu.beacon_chain import harness as jax_harness
from lighthouse_tpu.crypto import bls as jax_bls
from lighthouse_tpu.http_api import HttpApiServer as JaxServer
from lighthouse_tpu.ssz import core as jax_ssz
from lighthouse_tpu.types import MinimalEthSpec as JaxE
from lighthouse_tpu.types import minimal_spec as jax_minimal_spec
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch import state_processing as port_sp
from lighthouse_tpu_torch.beacon_chain import harness as port_harness
from lighthouse_tpu_torch.crypto import bls as port_bls
from lighthouse_tpu_torch.http_api import HttpApiServer as PortServer
from lighthouse_tpu_torch.ssz import core as port_ssz
from lighthouse_tpu_torch.types import MinimalEthSpec as PortE
from lighthouse_tpu_torch.types import minimal_spec as port_minimal_spec

N_VALIDATORS = 64
SLOTS = 34
SSZ = "application/octet-stream"
ZERO = "0x" + "00" * 32

JAX = SimpleNamespace(
    name="jax", harness=jax_harness, bls=jax_bls, sp=jax_sp, ssz=jax_ssz,
    Server=JaxServer, E=JaxE, spec=jax_minimal_spec,
)
PORT = SimpleNamespace(
    name="port", harness=port_harness, bls=port_bls, sp=port_sp, ssz=port_ssz,
    Server=PortServer, E=PortE, spec=port_minimal_spec,
)
SIDES = (JAX, PORT)


def _settings():
    return default_device(), jax_bls.backend_name(), port_bls.backend_setting()


def _restore(prev):
    set_default_device(prev[0])
    jax_bls.set_backend(prev[1])
    port_bls.set_backend(prev[2])


def _fake():
    set_default_device("cpu")
    jax_bls.set_backend("fake_crypto")
    port_bls.set_backend("fake_crypto")


@pytest.fixture(autouse=True)
def fake_crypto():
    prev = _settings()
    _fake()
    yield
    _restore(prev)


@pytest.fixture(scope="module")
def rig():
    """{side name: (harness, server)}, both serving."""
    prev = _settings()
    _fake()
    out = {}
    try:
        for side in SIDES:
            spec = replace(side.spec(), altair_fork_epoch=0)
            h = side.harness.BeaconChainHarness(spec, side.E, validator_count=N_VALIDATORS)
            h.extend_chain(SLOTS)
            h.attest_to_head(int(h.chain.head_state.slot))
            out[side.name] = (h, side.Server(h.chain).start())
        yield out
    finally:
        for _, srv in out.values():
            srv.stop()
        _restore(prev)


def request(port, path, accept=None, data=None, content_type=None):
    """(status, Content-Type, Eth-Consensus-Version, body bytes)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST" if data is not None else "GET")
    if accept:
        req.add_header("Accept", accept)
    if content_type:
        req.add_header("Content-Type", content_type)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.headers.get("Eth-Consensus-Version"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.headers.get("Eth-Consensus-Version"), e.read()


def _ids(h):
    """The values the route templates name, from one side's chain."""
    chain = h.chain
    E = chain.E
    st = chain.head_state
    slot = int(st.slot)
    fin = bytes(chain.finalized_checkpoint.root)
    agg = chain.op_pool.get_aggregate(h.make_attestations(slot, chain.head_root)[0].data.hash_tree_root())
    return {
        "head_slot": slot,
        "next_slot": slot + 1,
        "head_epoch": slot // E.SLOTS_PER_EPOCH,
        "next_epoch": slot // E.SLOTS_PER_EPOCH + 1,
        "prev_epoch": slot // E.SLOTS_PER_EPOCH - 1,
        "head_root": "0x" + bytes(chain.head_root).hex(),
        "head_state_root": "0x" + bytes(st.hash_tree_root()).hex(),
        "fin_root": "0x" + fin.hex(),
        "pubkey5": "0x" + bytes(st.validators[5].pubkey).hex(),
        "data_root": ZERO if agg is None else "0x" + bytes(agg.data.hash_tree_root()).hex(),
        "sig": "0x" + "c0" + "00" * 95,
    }


GET_ROUTES = [
    ("/eth/v1/node/version", None),
    ("/eth/v1/node/syncing", None),
    ("/eth/v1/node/identity", None),
    ("/eth/v1/node/peers", None),
    ("/eth/v1/node/peer_count", None),
    ("/eth/v1/node/health", None),
    ("/eth/v1/beacon/genesis", None),
    ("/eth/v1/beacon/states/head/root", None),
    ("/eth/v1/beacon/states/genesis/root", None),
    ("/eth/v1/beacon/states/finalized/root", None),
    ("/eth/v1/beacon/states/{head_slot}/root", None),
    ("/eth/v1/beacon/states/{head_state_root}/root", None),
    ("/eth/v1/beacon/states/7/root", None),
    ("/eth/v1/beacon/states/" + ZERO + "/root", None),
    ("/eth/v1/beacon/states/0xzz/root", None),
    ("/eth/v1/beacon/states/bogus/root", None),
    ("/eth/v1/beacon/states/head/fork", None),
    ("/eth/v1/beacon/states/finalized/fork", None),
    ("/eth/v1/beacon/states/head/finality_checkpoints", None),
    ("/eth/v1/beacon/states/finalized/finality_checkpoints", None),
    ("/eth/v1/beacon/states/head/validators/0", None),
    ("/eth/v1/beacon/states/head/validators/{pubkey5}", None),
    ("/eth/v1/beacon/states/head/validators/9999", None),
    ("/eth/v1/beacon/states/head/randao", None),
    ("/eth/v1/beacon/states/head/randao?epoch=2", None),
    ("/eth/v1/beacon/states/head/randao?epoch=x", None),
    ("/eth/v1/beacon/pool/proposer_slashings", None),
    ("/eth/v1/beacon/pool/attester_slashings", None),
    ("/eth/v1/beacon/pool/attestations", None),
    ("/eth/v1/beacon/pool/voluntary_exits", None),
    ("/eth/v1/beacon/rewards/blocks/head", None),
    ("/eth/v1/beacon/rewards/blocks/{head_slot}", None),
    ("/eth/v1/beacon/rewards/blocks/9", None),
    ("/eth/v1/beacon/rewards/blocks/" + ZERO, None),
    ("/eth/v1/beacon/headers/head", None),
    ("/eth/v1/beacon/headers/{head_slot}", None),
    ("/eth/v1/beacon/headers/{fin_root}", None),
    ("/eth/v1/beacon/headers/" + ZERO, None),
    ("/eth/v1/beacon/headers/nope", None),
    ("/eth/v1/beacon/blocks/head/root", None),
    ("/eth/v1/beacon/blocks/3/root", None),
    ("/eth/v1/beacon/blocks/999/root", None),
    ("/eth/v1/validator/duties/proposer/{head_epoch}", None),
    ("/eth/v1/validator/duties/proposer/{next_epoch}", None),
    ("/eth/v1/config/spec", None),
    ("/eth/v1/config/deposit_contract", None),
    ("/eth/v1/config/fork_schedule", None),
    ("/eth/v2/beacon/blocks/head", None),
    ("/eth/v2/beacon/blocks/head", SSZ),
    ("/eth/v2/beacon/blocks/{fin_root}", SSZ),
    ("/eth/v2/beacon/blocks/" + ZERO, SSZ),
    ("/eth/v2/debug/beacon/states/head", SSZ),
    ("/eth/v2/debug/beacon/states/finalized", SSZ),
    ("/eth/v2/debug/beacon/states/{head_state_root}", SSZ),
    ("/eth/v2/debug/beacon/states/bogus", SSZ),
    ("/eth/v1/beacon/states/head/committees", None),
    ("/eth/v1/beacon/states/head/committees?epoch={prev_epoch}", None),
    ("/eth/v1/beacon/states/finalized/committees", None),
    ("/eth/v1/beacon/states/head/validators", None),
    ("/eth/v1/beacon/states/head/validators?id=0,2&id={pubkey5}", None),
    ("/eth/v1/beacon/states/head/validators?status=active_ongoing&limit=5&offset=3", None),
    ("/eth/v1/beacon/states/head/validators?status=withdrawal_done", None),
    ("/eth/v1/beacon/states/finalized/validators?id=1", None),
    ("/eth/v1/beacon/states/head/validators?limit=x", None),
    ("/eth/v1/beacon/states/head/validator_balances", None),
    ("/eth/v1/beacon/states/head/validator_balances", SSZ),
    ("/eth/v1/beacon/states/head/validator_balances?id=3,4", None),
    ("/eth/v1/beacon/states/head/validator_balances?id=3,4", SSZ),
    ("/eth/v1/beacon/headers", None),
    ("/eth/v1/beacon/headers?slot=5", None),
    ("/eth/v1/beacon/headers?parent_root={fin_root}", None),
    ("/eth/v1/beacon/headers?slot=x", None),
    ("/eth/v1/beacon/blob_sidecars/head", None),
    ("/eth/v1/beacon/blob_sidecars/head", SSZ),
    ("/eth/v1/beacon/light_client/bootstrap/{fin_root}", None),
    ("/eth/v1/beacon/light_client/bootstrap/{head_root}", None),
    ("/eth/v1/beacon/light_client/bootstrap/" + ZERO, None),
    ("/eth/v1/beacon/light_client/update", None),
    ("/eth/v1/validator/aggregate_attestation?slot={head_slot}&attestation_data_root={data_root}", None),
    ("/eth/v1/validator/aggregate_attestation?slot={head_slot}&attestation_data_root=" + ZERO, None),
    ("/eth/v1/validator/aggregate_attestation?slot=x", None),
    ("/eth/v3/validator/blocks/{next_slot}?randao_reveal={sig}", None),
    ("/eth/v1/no/such/route", None),
]


def test_harnesses_agree(rig):
    jax_h, port_h = rig["jax"][0], rig["port"][0]
    assert bytes(port_h.chain.head_root) == bytes(jax_h.chain.head_root)
    assert _ids(port_h) == _ids(jax_h)
    assert (port_h.justified_epoch, port_h.finalized_epoch) == (3, 2)


@pytest.mark.parametrize("template,accept", GET_ROUTES, ids=[f"{t}|{a or 'json'}" for t, a in GET_ROUTES])
def test_get_route_equal(rig, template, accept):
    path = template.format(**_ids(rig["port"][0]))
    jax_out = request(rig["jax"][1].port, path, accept)
    port_out = request(rig["port"][1].port, path, accept)
    assert port_out == jax_out


def test_gets_cover_every_status(rig):
    """The route list reaches 200, 400 and 404 answers."""
    ids = _ids(rig["port"][0])
    codes = {request(rig["port"][1].port, t.format(**ids), a)[0] for t, a in GET_ROUTES}
    assert {200, 400, 404} <= codes


def test_response_cache_keys_equal(rig):
    ids = _ids(rig["port"][0])
    for _, srv in rig.values():
        for template, accept in GET_ROUTES:
            request(srv.port, template.format(**ids), accept)
    keys = {name: sorted(srv.api.response_cache._entries) for name, (_, srv) in rig.items()}
    assert keys["port"] == keys["jax"]
    assert keys["port"]


def _post_cases(side, h):
    """(name, path, body, content type) of the POSTs, built on `side`."""
    chain = h.chain
    t = chain.types
    E = chain.E
    slot = int(chain.head_state.slot)
    epoch = slot // E.SLOTS_PER_EPOCH
    atts = h.make_unaggregated_attestations(slot, chain.head_root)[:6]
    att_list = side.ssz.List[t.Attestation, 1024].serialize_value(atts)
    exit_ = t.SignedVoluntaryExit(message=t.VoluntaryExit(epoch=epoch, validator_index=3), signature=b"\xc0" + b"\x00" * 95)
    return [
        ("block_json", "/eth/v1/beacon/blocks", b"{}", "application/json"),
        ("block_garbage", "/eth/v1/beacon/blocks", b"\x01\x02\x03", SSZ),
        ("exit_json", "/eth/v1/beacon/pool/voluntary_exits", b"{}", "application/json"),
        ("exit_garbage", "/eth/v1/beacon/pool/voluntary_exits", b"\x00", SSZ),
        ("exit", "/eth/v1/beacon/pool/voluntary_exits", exit_.serialize(), SSZ),
        ("attestations", "/eth/v1/beacon/pool/attestations", att_list, SSZ),
        ("attestations_again", "/eth/v1/beacon/pool/attestations", att_list, SSZ),
        ("aggregates_empty", "/eth/v1/validator/aggregate_and_proofs", b"", SSZ),
        ("sync_messages_empty", "/eth/v1/beacon/pool/sync_committees", b"", SSZ),
        ("prepare_bad", "/eth/v1/validator/prepare_beacon_proposer", json.dumps([{"validator_index": "1", "fee_recipient": "0x12"}]).encode(), "application/json"),
        ("prepare", "/eth/v1/validator/prepare_beacon_proposer", json.dumps([{"validator_index": "1", "fee_recipient": "0x" + "ab" * 20}]).encode(), "application/json"),
        ("sync_rewards", "/eth/v1/beacon/rewards/sync_committee/head", b"", "application/json"),
        ("sync_rewards_ids", "/eth/v1/beacon/rewards/sync_committee/head", json.dumps(["1", "7"]).encode(), "application/json"),
        ("attestation_rewards", "/eth/v1/beacon/rewards/attestations/1", b"", "application/json"),
        ("attestation_rewards_ids", "/eth/v1/beacon/rewards/attestations/2", json.dumps(["0", "9"]).encode(), "application/json"),
        ("attestation_rewards_future", f"/eth/v1/beacon/rewards/attestations/{epoch}", b"", "application/json"),
        ("attester_duties", f"/eth/v1/validator/duties/attester/{epoch}", json.dumps(["0", "5", "63"]).encode(), "application/json"),
        ("sync_duties", f"/eth/v1/validator/duties/sync/{epoch}", json.dumps([str(i) for i in range(N_VALIDATORS)]).encode(), "application/json"),
        ("proposer_slashing_garbage", "/eth/v1/beacon/pool/proposer_slashings", b"\x00", SSZ),
        ("attester_slashing_garbage", "/eth/v1/beacon/pool/attester_slashings", b"\x00", SSZ),
        ("unknown", "/eth/v1/no/such/route", b"{}", "application/json"),
    ]


POST_NAMES = [
    "block_json", "block_garbage", "exit_json", "exit_garbage", "exit", "attestations",
    "attestations_again", "aggregates_empty", "sync_messages_empty", "prepare_bad", "prepare",
    "sync_rewards", "sync_rewards_ids", "attestation_rewards", "attestation_rewards_ids",
    "attestation_rewards_future", "attester_duties", "sync_duties", "proposer_slashing_garbage",
    "attester_slashing_garbage", "unknown",
]


@pytest.mark.parametrize("name", POST_NAMES)
def test_post_route_equal(rig, name):
    out = {}
    for side in SIDES:
        h, srv = rig[side.name]
        cases = {c[0]: c[1:] for c in _post_cases(side, h)}
        path, body, ctype = cases[name]
        out[side.name] = request(srv.port, path, data=body, content_type=ctype) + (bytes(h.chain.head_root),)
    assert out["port"] == out["jax"]


def test_post_names_cover_the_cases(rig):
    assert [c[0] for c in _post_cases(PORT, rig["port"][0])] == POST_NAMES


def _next_block(side, h):
    chain = h.chain
    slot = int(chain.head_state.slot) + 1
    h.slot_clock.set_slot(slot)
    state = chain.head_state.copy()
    while state.slot < slot:
        side.sp.per_slot_processing(state, h.spec, h.E)
    proposer = side.sp.get_beacon_proposer_index(state, h.E)
    parent = chain.head_root
    block, _ = chain.produce_block_on_state(
        slot, h.randao_reveal(proposer, slot, state), sync_aggregate_fn=lambda st: h.make_sync_aggregate(st, slot, parent)
    )
    return h.sign_block(block, state)


def test_post_block_moves_the_head_alike(rig):
    out = {}
    for side in SIDES:
        h, srv = rig[side.name]
        signed = _next_block(side, h)
        data = signed.serialize()
        first = request(srv.port, "/eth/v1/beacon/blocks", data=data, content_type=SSZ)
        head = bytes(h.chain.head_root)
        again = request(srv.port, "/eth/v1/beacon/blocks", data=data, content_type=SSZ)
        root_body = request(srv.port, "/eth/v1/beacon/states/head/root")
        header = request(srv.port, "/eth/v1/beacon/headers")
        # attestations to the new head: accepted, then refused as repeats
        atts = h.make_unaggregated_attestations(int(signed.message.slot), head)[:6]
        att_list = side.ssz.List[h.chain.types.Attestation, 1024].serialize_value(atts)
        posted = [request(srv.port, "/eth/v1/beacon/pool/attestations", data=att_list, content_type=SSZ) for _ in range(2)]
        pool = request(srv.port, "/eth/v1/beacon/pool/attestations")
        out[side.name] = (first, again, head, bytes(signed.message.hash_tree_root()), root_body, header, posted, pool)
    assert out["port"] == out["jax"]
    first, _, head, root, _, _, posted, _ = out["port"]
    assert first[0] == 200 and head == root
    assert [p[0] for p in posted] == [200, 400]
