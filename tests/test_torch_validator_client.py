"""The port's validator client (validator_client/{__init__,
slashing_protection,beacon_node_fallback,http_api}.py) against
lighthouse_tpu's, on the CPU device with the host BLS backends.

Both VCs drive their package's minimal harness (Altair from genesis)
for two epochs with the same interop keys, over GossipingBeaconNode (the
in-process node plus a stub network that records what it is handed),
with the same conflicting history written into their slashing databases
first, so that both refuse the same attestation and the same proposal.
Their block roots, published objects (signatures included), refusals
and EIP-3076 interchange must be equal; so must the port's batch
pipeline and its per-key oracle (`LIGHTHOUSE_TPU_VC_BATCH=0`). The port's
VC over HTTP, through a BeaconNodeFallback whose first candidate is a
closed port, reaches the same head. The keymanager routes answer both
packages' VCs alike, with and without the token. Every server binds
127.0.0.1 on port 0 and is stopped in teardown; every client call has a
timeout of a few seconds. Tolerance: exact equality."""

import json
import os
import urllib.error
import urllib.request
from dataclasses import replace
from types import SimpleNamespace

import pytest

import lighthouse_tpu.metrics as jax_metrics
import lighthouse_tpu.validator_client as jax_vc
import lighthouse_tpu_torch.metrics as port_metrics
import lighthouse_tpu_torch.validator_client as port_vc
from chip_smoke import _closed_port
from lighthouse_tpu.beacon_chain.harness import BeaconChainHarness as JaxHarness
from lighthouse_tpu.crypto import bls as jax_bls
from lighthouse_tpu.crypto.keystore import Keystore as JaxKeystore
from lighthouse_tpu.types.chain_spec import minimal_spec as jax_minimal_spec
from lighthouse_tpu.types.eth_spec import MinimalEthSpec as JaxE
from lighthouse_tpu.validator_client import http_api as jax_km
from lighthouse_tpu.validator_client import slashing_protection as jax_sp
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.beacon_chain.harness import BeaconChainHarness as PortHarness
from lighthouse_tpu_torch.crypto import bls as port_bls
from lighthouse_tpu_torch.eth2 import BeaconNodeHttpClient, HttpBeaconNode
from lighthouse_tpu_torch.http_api import HttpApiServer
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as port_minimal_spec
from lighthouse_tpu_torch.types.containers import build_types as port_build_types
from lighthouse_tpu_torch.types.eth_spec import MinimalEthSpec as PortE
from lighthouse_tpu_torch.validator_client import beacon_node_fallback as port_fb
from lighthouse_tpu_torch.validator_client import http_api as port_km
from lighthouse_tpu_torch.validator_client import slashing_protection as port_sp

VALIDATORS = 8
SLOTS = 2 * 8  # two minimal epochs
REFUSED_PROPOSAL_SLOT = 5
TIMEOUT = 5.0

JAX = SimpleNamespace(vc=jax_vc, sp=jax_sp, km=jax_km, bls=jax_bls, metrics=jax_metrics, Harness=JaxHarness, spec=jax_minimal_spec, E=JaxE)
PORT = SimpleNamespace(vc=port_vc, sp=port_sp, km=port_km, bls=port_bls, metrics=port_metrics, Harness=PortHarness, spec=port_minimal_spec, E=PortE)


@pytest.fixture(scope="module", autouse=True)
def cpu_device_and_host_backends():
    prev = default_device(), jax_bls.backend_name(), port_bls.backend_setting(), os.environ.get("LIGHTHOUSE_TPU_HOST_POOL")
    set_default_device("cpu")
    jax_bls.set_backend("host")
    port_bls.set_backend(None)  # follows the CPU device: host
    os.environ["LIGHTHOUSE_TPU_HOST_POOL"] = "1"  # the batch signer inline
    yield
    set_default_device(prev[0])
    jax_bls.set_backend(prev[1])
    port_bls.set_backend(prev[2])
    if prev[3] is None:
        os.environ.pop("LIGHTHOUSE_TPU_HOST_POOL", None)
    else:
        os.environ["LIGHTHOUSE_TPU_HOST_POOL"] = prev[3]


class _Network:
    """The stub gossip network GossipingBeaconNode publishes to."""

    def __init__(self):
        self.published = []

    def publish_block(self, signed):
        self.published.append(("block", signed.serialize()))

    def publish_attestation(self, att):
        self.published.append(("attestation", att.serialize()))

    def publish_sync_committee_message(self, msg):
        self.published.append(("sync", msg.serialize()))

    def publish_aggregate(self, agg):
        self.published.append(("aggregate", agg.serialize()))


def _counter(pkg, name: str) -> float:
    return pkg.metrics.REGISTRY.counter(name).value()


COUNTERS = (
    "vc_slashing_protection_refusals_total",
    "vc_attestations_published_total",
    "vc_blocks_published_total",
    "vc_aggregates_published_total",
    "vc_sync_committee_messages_published_total",
)


def _conflicting_history(db, keypairs):
    """Key 0 already voted for another epoch-1 target."""
    db.check_and_insert_attestation(keypairs[0].pk.to_bytes(), 0, 1, b"\x11" * 32)


def _on_slots(vc, h):
    """Run the VC's slots; just before REFUSED_PROPOSAL_SLOT, its proposer
    is recorded as having proposed another block there."""
    roots = []
    for slot in range(1, SLOTS + 1):
        h.slot_clock.set_slot(slot)
        if slot == REFUSED_PROPOSAL_SLOT:
            _index, pubkey, _state = vc.duties_service.proposer_duty_at(slot)
            vc.store.slashing_db.check_and_insert_block_proposal(pubkey, slot, b"\x22" * 32)
        roots.append(vc.on_slot(slot))
    return roots


def _set_batch(batch: bool):
    prev = os.environ.get("LIGHTHOUSE_TPU_VC_BATCH")
    os.environ["LIGHTHOUSE_TPU_VC_BATCH"] = "1" if batch else "0"
    return prev


def _restore_batch(prev):
    if prev is None:
        os.environ.pop("LIGHTHOUSE_TPU_VC_BATCH", None)
    else:
        os.environ["LIGHTHOUSE_TPU_VC_BATCH"] = prev


def _summary(pkg, h, vc, roots, base, network=None):
    chain = h.chain
    gvr = bytes(chain.genesis_validators_root)
    return {
        "roots": [None if r is None else bytes(r).hex() for r in roots],
        "published": network.published if network is not None else None,
        "head": bytes(chain.head_root).hex(),
        "justified": int(chain.head_state.current_justified_checkpoint.epoch),
        "counters": {k: _counter(pkg, k) - base[k] for k in COUNTERS},
        "interchange": vc.store.slashing_db.export_interchange(gvr),
    }


def _drive(pkg, batch: bool = True) -> dict:
    prev = _set_batch(batch)
    try:
        spec = replace(pkg.spec(), altair_fork_epoch=0)
        h = pkg.Harness(spec, pkg.E, validator_count=VALIDATORS)
        net = _Network()
        vc = pkg.vc.ValidatorClient(h.chain, h.keypairs, spec, pkg.E, node=pkg.vc.GossipingBeaconNode(h.chain, net))
        _conflicting_history(vc.store.slashing_db, h.keypairs)
        base = {k: _counter(pkg, k) for k in COUNTERS}
        return _summary(pkg, h, vc, _on_slots(vc, h), base, net)
    finally:
        _restore_batch(prev)


@pytest.fixture(scope="module")
def drives():
    return {"jax": _drive(JAX), "port": _drive(PORT), "port_per_key": _drive(PORT, batch=False)}


def test_block_roots_and_head_equal(drives):
    port, jax = drives["port"], drives["jax"]
    assert port["roots"] == jax["roots"]
    assert port["head"] == jax["head"] and port["justified"] == jax["justified"]
    # the conflicting proposal was refused: no block at that slot only
    assert [i + 1 for i, r in enumerate(port["roots"]) if r is None] == [REFUSED_PROPOSAL_SLOT]


def test_published_objects_and_signatures_equal(drives):
    port, jax = drives["port"]["published"], drives["jax"]["published"]
    assert len(port) == len(jax)
    assert port == jax
    kinds = {k for k, _ in port}
    assert kinds == {"block", "attestation", "aggregate", "sync"}


def test_refusals_and_counters_equal(drives):
    port, jax = drives["port"]["counters"], drives["jax"]["counters"]
    assert port == jax
    # key 0's epoch-0 vote (below its recorded target), its epoch-1 vote
    # (a double vote) and the slot's proposal
    assert port["vc_slashing_protection_refusals_total"] == 3
    assert port["vc_blocks_published_total"] == SLOTS - 1


def test_slashing_interchange_equal(drives):
    port, jax = drives["port"]["interchange"], drives["jax"]["interchange"]
    assert json.dumps(port, sort_keys=True) == json.dumps(jax, sort_keys=True)
    assert len(port["data"]) == VALIDATORS


@pytest.mark.parametrize("part", ["roots", "published", "head", "counters", "interchange"])
def test_batch_pipeline_equals_per_key_oracle(drives, part):
    assert drives["port"][part] == drives["port_per_key"][part]


def test_interchange_imports_across_packages(drives):
    doc = drives["jax"]["interchange"]
    gvr = bytes.fromhex(doc["metadata"]["genesis_validators_root"].removeprefix("0x"))
    pk0 = bytes.fromhex(doc["data"][0]["pubkey"].removeprefix("0x"))
    verdicts = []
    for sp in (port_sp, jax_sp):
        db = sp.SlashingDatabase()
        db.import_interchange(json.loads(json.dumps(drives["port"]["interchange"])), gvr)
        try:
            db.check_and_insert_attestation(pk0, 0, 1, b"\x33" * 32)
            verdicts.append("signed")
        except sp.NotSafe as e:
            verdicts.append(str(e))
        with pytest.raises(sp.NotSafe):
            sp.SlashingDatabase().import_interchange(doc, b"\x00" * 32)
    assert verdicts[0] == verdicts[1] != "signed"


# -- the VC over HTTP, through the fallback --------------------------------------


@pytest.fixture
def api_servers():
    started = []
    yield started
    for srv in started:
        srv.stop()


def test_vc_over_http_reaches_the_same_head(drives, api_servers):
    prev = _set_batch(True)
    try:
        spec = replace(port_minimal_spec(), altair_fork_epoch=0)
        h = PortHarness(spec, PortE, validator_count=VALIDATORS)
        srv = HttpApiServer(h.chain, port=0).start()
        api_servers.append(srv)
        types = port_build_types(PortE)
        dead = HttpBeaconNode(BeaconNodeHttpClient(f"http://127.0.0.1:{_closed_port()}", timeout=TIMEOUT), types)
        live = HttpBeaconNode(BeaconNodeHttpClient(f"http://127.0.0.1:{srv.port}", timeout=TIMEOUT), types)
        fallback = port_fb.BeaconNodeFallback([dead, live], recheck_interval=3600.0)
        vc = port_vc.ValidatorClient(None, h.keypairs, spec, PortE, node=fallback)
        _conflicting_history(vc.store.slashing_db, h.keypairs)
        base = {k: _counter(PORT, k) for k in COUNTERS}
        got = _summary(PORT, h, vc, _on_slots(vc, h), base)
    finally:
        _restore_batch(prev)
    local = drives["port"]
    assert got["roots"] == local["roots"] and got["head"] == local["head"]
    assert got["interchange"] == local["interchange"]
    assert got["counters"] == local["counters"]
    assert [c.health for c in fallback.candidates] == [port_fb.CandidateHealth.OFFLINE, port_fb.CandidateHealth.ONLINE]


class _Node:
    def __init__(self, name, fail=False, bulk=True):
        self.name, self.fail, self.calls = name, fail, []
        if bulk:
            self.attester_duties = lambda epoch, indices: self._call("attester_duties", epoch)

    def _call(self, method, *args):
        self.calls.append(method)
        if self.fail:
            raise ConnectionError(f"{self.name} down")
        return (self.name, method, args)

    def head_root(self):
        return self._call("head_root")

    def head_state(self):
        return self._call("head_state")


def _failover(fb_mod):
    """First success in declaration order; a failed candidate is marked
    offline and re-probed once its recheck interval has passed; all
    failing raises AllNodesFailed."""
    a, b = _Node("a", fail=True), _Node("b")
    fb = fb_mod.BeaconNodeFallback([a, b], recheck_interval=3600.0)
    out = [fb.head_root(), [c.health.value for c in fb.candidates]]
    out.append(fb.head_state())
    out.append((list(a.calls), list(b.calls)))
    a.fail = False
    fb.candidates[0].last_check -= 7200.0  # the interval has passed
    out.append(fb.head_root())
    out.append([c.health.value for c in fb.candidates])
    a.fail = b.fail = True
    fb.candidates[0].last_check -= 7200.0
    try:
        fb.head_state()
    except fb_mod.AllNodesFailed as e:
        out.append(("AllNodesFailed", len(e.errors)))
    with pytest.raises(ValueError):
        fb_mod.BeaconNodeFallback([])
    return out


def test_fallback_failover_equal():
    from lighthouse_tpu.validator_client import beacon_node_fallback as jax_fb

    port = _failover(port_fb)
    assert port == _failover(jax_fb)
    assert port[0] == ("b", "head_root", ()) and port[1] == ["offline", "online"]
    assert port[4] == ("a", "head_root", ())
    assert port[6] == ("AllNodesFailed", 2)


def test_fallback_without_bulk_duties_leaves_the_scan_to_the_duties_service():
    """Where the packages differ: with no candidate serving bulk duties
    (HttpBeaconNode has none) the port's fallback raises
    NotImplementedError and leaves every candidate's health alone, so
    DutiesService scans; the JAX package's marks every candidate offline
    and raises AllNodesFailed, which DutiesService does not catch."""
    from lighthouse_tpu.validator_client import beacon_node_fallback as jax_fb

    port = port_fb.BeaconNodeFallback([_Node("a", bulk=False), _Node("b", bulk=False)])
    with pytest.raises(NotImplementedError):
        port.attester_duties(0, [1])
    assert [c.health.value for c in port.candidates] == ["unknown", "unknown"]
    jax = jax_fb.BeaconNodeFallback([_Node("a", bulk=False), _Node("b", bulk=False)])
    with pytest.raises(jax_fb.AllNodesFailed):
        jax.attester_duties(0, [1])
    assert [c.health.value for c in jax.candidates] == ["offline", "offline"]
    # with the bulk surface both forward to the first candidate that serves it
    both = [fb.BeaconNodeFallback([_Node("a", fail=True), _Node("b")]).attester_duties(3, [1]) for fb in (port_fb, jax_fb)]
    assert both[0] == both[1] == ("b", "attester_duties", (3,))


# -- the keymanager API ------------------------------------------------------------------


TOKEN = "ab" * 32


@pytest.fixture
def keymanagers():
    started = []

    def serve(pkg):
        kps = pkg.bls.interop_keypairs(4)
        vc = pkg.vc.ValidatorClient(None, kps, replace(pkg.spec(), altair_fork_epoch=0), pkg.E, node=SimpleNamespace())
        srv = pkg.km.KeymanagerServer(vc, token=TOKEN).start()
        started.append(srv)
        return vc, f"http://127.0.0.1:{srv.port}"

    yield serve
    for srv in started:
        srv.stop()


def _call(base, method, path, body=None, token=TOKEN):
    data = json.dumps(body).encode() if body is not None else None
    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(base + path, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _keymanager_session(base, keystore_json, pk5_hex):
    """The same requests to one keymanager: the token, a wrong one, or no
    Authorization header (None)."""
    imp = {"keystores": [keystore_json], "passwords": ["pw"]}
    calls = [
        ("GET", "/eth/v1/keystores", None, None),
        ("GET", "/eth/v1/keystores", None, "wrong"),
        ("POST", "/eth/v1/keystores", imp, None),
        ("POST", "/eth/v1/keystores", imp, TOKEN),
        ("POST", "/eth/v1/keystores", {"keystores": [keystore_json, keystore_json], "passwords": ["pw", "bad"]}, TOKEN),
        ("POST", "/eth/v1/keystores", {"keystores": [keystore_json], "passwords": []}, TOKEN),
        ("GET", "/eth/v1/keystores", None, TOKEN),
        ("POST", f"/eth/v1/validator/{pk5_hex}/feerecipient", {"ethaddress": "0x" + "ee" * 20}, TOKEN),
        ("POST", f"/eth/v1/validator/{pk5_hex}/feerecipient", {"ethaddress": "0x" + "ee" * 19}, TOKEN),
        ("GET", f"/eth/v1/validator/{pk5_hex}/feerecipient", None, TOKEN),
        ("DELETE", "/eth/v1/keystores", {"pubkeys": [pk5_hex, "0x" + "00" * 48, "0xzz"]}, TOKEN),
        ("DELETE", "/eth/v1/keystores", {"pubkeys": [pk5_hex]}, None),
        ("GET", "/eth/v1/nothing", None, TOKEN),
        ("GET", "/eth/v1/keystores", None, TOKEN),
    ]
    return [_call(base, method, path, body, token=token) for method, path, body, token in calls]


def test_keymanager_routes_with_and_without_the_token(keymanagers):
    kp5 = port_bls.interop_keypairs(6)[5]
    # one keystore document, imported by both VCs
    ks = JaxKeystore.encrypt(kp5.sk.scalar.to_bytes(32, "big"), "pw", kdf="pbkdf2", pubkey=kp5.pk.to_bytes(), _fast_kdf=True)
    pk5_hex = "0x" + kp5.pk.to_bytes().hex()
    sessions = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        vc, base = keymanagers(pkg)
        sessions[name] = _keymanager_session(base, ks.to_json(), pk5_hex)
        assert vc.store.signer_for(kp5.pk.to_bytes()) is None
        assert len(vc.store.pubkeys()) == 4
    assert sessions["port"] == sessions["jax"]
    codes = [code for code, _ in sessions["port"]]
    assert codes == [401, 401, 401, 200, 200, 400, 200, 202, 400, 200, 200, 401, 404, 200]
    assert [len(sessions["port"][i][1]["data"]) for i in (6, 13)] == [5, 4]
    assert sessions["port"][3][1]["data"] == [{"status": "imported"}]
    assert [s["status"] for s in sessions["port"][4][1]["data"]] == ["duplicate", "error"]
    deleted = sessions["port"][10][1]
    assert [s["status"] for s in deleted["data"]] == ["deleted", "not_found", "error"]
    assert json.loads(deleted["slashing_protection"])["metadata"]["interchange_format_version"] == "5"
