"""The port's engine API (execution_layer/{auth,http,watchdog,
builder_client}.py) against lighthouse_tpu's: JWTs and their verdicts,
the camelCase/0x-hex payload codec for Bellatrix to Electra, each
package's JSON-RPC client against the other package's MockEngineServer,
the watchdog's ONLINE/OFFLINE cycle with its gauges, and MockBuilder's
bids; and the monitoring push (metrics/monitoring.py) to a local
receiver. Every server binds 127.0.0.1 on port 0 and is stopped in
teardown; every client call has a timeout of a few seconds. Tolerance:
exact equality of bytes, JSON documents, statuses and verdicts."""

import hashlib
import hmac
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest

import lighthouse_tpu.execution_layer as jax_el
import lighthouse_tpu.metrics as jax_metrics
import lighthouse_tpu_torch.execution_layer as port_el
import lighthouse_tpu_torch.metrics as port_metrics
from lighthouse_tpu.execution_layer import auth as jax_auth
from lighthouse_tpu.execution_layer import builder_client as jax_builder
from lighthouse_tpu.execution_layer import http as jax_http
from lighthouse_tpu.execution_layer import watchdog as jax_watchdog
from lighthouse_tpu.metrics import monitoring as jax_monitoring
from lighthouse_tpu.types.chain_spec import ForkName as JaxForkName
from lighthouse_tpu.types.containers import build_types as jax_build_types
from lighthouse_tpu.types.eth_spec import MinimalEthSpec as JaxE
from lighthouse_tpu_torch.execution_layer import auth as port_auth
from lighthouse_tpu_torch.execution_layer import builder_client as port_builder
from lighthouse_tpu_torch.execution_layer import http as port_http
from lighthouse_tpu_torch.execution_layer import watchdog as port_watchdog
from lighthouse_tpu_torch.metrics import monitoring as port_monitoring
from lighthouse_tpu_torch.types.chain_spec import ForkName as PortForkName
from lighthouse_tpu_torch.types.containers import build_types as port_build_types
from lighthouse_tpu_torch.types.eth_spec import MinimalEthSpec as PortE

SECRET = bytes(range(32))
IAT = 1_700_000_000
TIMEOUT = 5.0
FORKS = ("bellatrix", "capella", "deneb", "electra")


JAX = SimpleNamespace(
    el=jax_el, auth=jax_auth, http=jax_http, watchdog=jax_watchdog, builder=jax_builder,
    metrics=jax_metrics, monitoring=jax_monitoring, F=JaxForkName, T=jax_build_types(JaxE), E=JaxE,
)
PORT = SimpleNamespace(
    el=port_el, auth=port_auth, http=port_http, watchdog=port_watchdog, builder=port_builder,
    metrics=port_metrics, monitoring=port_monitoring, F=PortForkName, T=port_build_types(PortE), E=PortE,
)
PKGS = {"jax": JAX, "port": PORT}


# -- JWT ---------------------------------------------------------------------


@pytest.mark.parametrize("claims", [None, {"id": "cl", "clv": "v1"}])
def test_jwt_with_fixed_iat_is_byte_equal(claims):
    port = port_auth.generate_jwt(SECRET, iat=IAT, claims=claims)
    assert port == jax_auth.generate_jwt(SECRET, iat=IAT, claims=claims)
    assert port_auth.validate_jwt(port, SECRET, now=IAT) == jax_auth.validate_jwt(port, SECRET, now=IAT)


def _verdict(auth, token, secret, now):
    try:
        return ("ok", auth.validate_jwt(token, secret, now=now))
    except auth.JwtError as e:
        return ("JwtError", str(e))


@pytest.mark.parametrize(
    "case",
    ["fresh", "edge_past", "expired", "edge_future", "future", "bad_signature", "malformed", "bad_alg", "not_base64"],
)
def test_validate_jwt_verdicts_equal(case):
    tol = port_auth.JWT_DRIFT_TOLERANCE_S
    assert tol == jax_auth.JWT_DRIFT_TOLERANCE_S
    token, secret, now = port_auth.generate_jwt(SECRET, iat=IAT), SECRET, IAT
    if case == "edge_past":
        now = IAT + tol
    elif case == "expired":
        now = IAT + tol + 1
    elif case == "edge_future":
        now = IAT - tol
    elif case == "future":
        now = IAT - tol - 1
    elif case == "bad_signature":
        secret = b"\x01" * 32
    elif case == "malformed":
        token = token.rsplit(".", 1)[0]
    elif case == "bad_alg":
        head = port_auth._b64url(json.dumps({"alg": "none", "typ": "JWT"}, separators=(",", ":")).encode())
        body = token.split(".")[1]
        sig = hmac.new(SECRET, f"{head}.{body}".encode(), hashlib.sha256).digest()
        token = f"{head}.{body}.{port_auth._b64url(sig)}"
    elif case == "not_base64":
        token = "a.b.c"
    port = _verdict(port_auth, token, secret, now)
    assert port == _verdict(jax_auth, token, secret, now)
    assert (port[0] == "ok") == (case in ("fresh", "edge_past", "edge_future"))


def test_load_jwt_secret_equal(tmp_path):
    p = tmp_path / "jwtsecret"
    p.write_text("0x" + SECRET.hex() + "\n")
    for arg in (str(p), SECRET.hex(), "0x" + SECRET.hex()):
        assert port_auth.load_jwt_secret(arg) == jax_auth.load_jwt_secret(arg) == SECRET
    for auth in (port_auth, jax_auth):
        with pytest.raises(auth.JwtError):
            auth.load_jwt_secret("00" * 31)


# -- the payload codec ---------------------------------------------------------


def _withdrawals(T, rng, n):
    return [
        T.Withdrawal(index=int(rng.integers(0, 2**40)), validator_index=int(rng.integers(0, 2**20)), address=rng.bytes(20), amount=int(rng.integers(0, 2**50)))
        for _ in range(n)
    ]


def _payload(pkg, fork: str, seed: int):
    """A payload of `fork` from seeded fields, each field set."""
    rng = np.random.default_rng(seed)
    T = pkg.T
    kw = dict(
        parent_hash=rng.bytes(32), fee_recipient=rng.bytes(20), state_root=rng.bytes(32), receipts_root=rng.bytes(32),
        logs_bloom=rng.bytes(256), prev_randao=rng.bytes(32), block_number=int(rng.integers(0, 2**40)),
        gas_limit=30_000_000, gas_used=int(rng.integers(0, 30_000_000)), timestamp=int(rng.integers(0, 2**40)),
        extra_data=rng.bytes(int(rng.integers(0, 33))), base_fee_per_gas=int(rng.integers(0, 2**62)) * 2**64 + 5,
        block_hash=rng.bytes(32), transactions=[rng.bytes(int(rng.integers(1, 200))) for _ in range(3)],
    )
    if fork == "bellatrix":
        return T.ExecutionPayload(**kw)
    kw["withdrawals"] = _withdrawals(T, rng, 4)
    if fork == "capella":
        return T.ExecutionPayloadCapella(**kw)
    kw["blob_gas_used"], kw["excess_blob_gas"] = 131072, int(rng.integers(0, 2**40))
    if fork == "deneb":
        return T.ExecutionPayloadDeneb(**kw)
    kw["deposit_receipts"] = [
        T.DepositReceipt(pubkey=rng.bytes(48), withdrawal_credentials=rng.bytes(32), amount=32_000_000_000, signature=rng.bytes(96), index=i)
        for i in range(2)
    ]
    kw["withdrawal_requests"] = [T.ExecutionLayerWithdrawalRequest(source_address=rng.bytes(20), validator_pubkey=rng.bytes(48), amount=7)]
    return T.ExecutionPayloadElectra(**kw)


@pytest.mark.parametrize("fork", FORKS)
def test_payload_codec_equal(fork):
    port, jax = _payload(PORT, fork, 3), _payload(JAX, fork, 3)
    assert port.serialize() == jax.serialize()
    doc = port_http.payload_to_json(port)
    assert doc == jax_http.payload_to_json(jax)
    # through the wire's JSON text, each package decodes the other's document
    wire = json.loads(json.dumps(doc))
    back_port = port_http.payload_from_json(wire, PORT.T, PortForkName(fork))
    back_jax = jax_http.payload_from_json(wire, JAX.T, JaxForkName(fork))
    assert back_port.serialize() == back_jax.serialize() == port.serialize()


@pytest.mark.parametrize("fork", FORKS)
def test_attributes_codec_equal(fork):
    docs = {}
    for name, pkg in PKGS.items():
        rng = np.random.default_rng(8)
        attrs = pkg.el.PayloadAttributes(
            timestamp=int(rng.integers(0, 2**40)), prev_randao=rng.bytes(32), suggested_fee_recipient=rng.bytes(20),
            withdrawals=_withdrawals(pkg.T, rng, 3), parent_beacon_block_root=rng.bytes(32),
        )
        docs[name] = pkg.http.attributes_to_json(attrs, pkg.F(fork))
        back = pkg.http.attributes_from_json(json.loads(json.dumps(docs[name])), pkg.T)
        docs[name + "_back"] = (back.timestamp, back.prev_randao, back.suggested_fee_recipient, [w.serialize() for w in back.withdrawals], back.parent_beacon_block_root)
    assert docs["port"] == docs["jax"]
    assert docs["port_back"] == docs["jax_back"]
    assert ("withdrawals" in docs["port"]) == (fork != "bellatrix")
    assert ("parentBeaconBlockRoot" in docs["port"]) == (fork in ("deneb", "electra"))


# -- each client against the other package's server ------------------------------


@pytest.fixture
def servers():
    started = []

    def serve(pkg, engine=None):
        engine = engine or pkg.el.MockExecutionLayer(pkg.T, pkg.E)
        srv = pkg.http.MockEngineServer(engine, SECRET, pkg.T, pkg.E).start()
        started.append(srv)
        return engine, srv

    yield serve
    for srv in started:
        srv.stop()


def _drive_engine(client, pkg):
    """A merge-era sequence through one client: the terminal block, then a
    payload a fork from Bellatrix to Electra, each notified back; the
    statuses and the payloads' bytes in order."""
    out = []
    parent = None
    for i, fork in enumerate(FORKS):
        F = pkg.F(fork)
        attrs = pkg.el.PayloadAttributes(
            timestamp=12 * (i + 1), prev_randao=bytes([i + 1]) * 32, suggested_fee_recipient=bytes([0xA0 + i]) * 20,
            withdrawals=_withdrawals(pkg.T, np.random.default_rng(i), 2) if fork != "bellatrix" else [],
            parent_beacon_block_root=bytes([0xB0 + i]) * 32 if fork in ("deneb", "electra") else None,
        )
        payload = client.get_payload(parent, attrs, F)
        request = SimpleNamespace(execution_payload=payload, versioned_hashes=[], parent_beacon_block_root=attrs.parent_beacon_block_root)
        status = client.notify_new_payload(request)
        fcu = client.notify_forkchoice_updated(pkg.el.ForkchoiceState(bytes(payload.block_hash), bytes(payload.block_hash), b"\x00" * 32), None)
        out.append((fork, payload.serialize(), status.value, fcu.value))
        parent = bytes(payload.block_hash)
    pow_block = client.get_pow_block(parent)
    out.append(("pow", pow_block is None))
    return out


def test_each_client_against_the_other_package_server(servers):
    _, jax_srv = servers(JAX)
    _, port_srv = servers(PORT)
    port_on_jax = _drive_engine(port_http.HttpEngineClient(jax_srv.url, SECRET, PORT.T, timeout=TIMEOUT), PORT)
    jax_on_port = _drive_engine(jax_http.HttpEngineClient(port_srv.url, SECRET, JAX.T, timeout=TIMEOUT), JAX)
    # the payloads, the forkchoice statuses and the PoW lookup are equal
    assert [(o[0], o[1], o[3]) for o in port_on_jax[:4]] == [(o[0], o[1], o[3]) for o in jax_on_port[:4]]
    assert port_on_jax[4] == jax_on_port[4]
    # newPayload: equal through Capella; from Deneb on only the port's
    # server passes the parent beacon block root to the engine
    assert [o[2] for o in jax_on_port[:4]] == ["VALID", "VALID", "VALID", "VALID"]
    assert [o[2] for o in port_on_jax[:4]] == ["VALID", "VALID", "INVALID", "INVALID"]


def test_each_client_against_its_own_package_server(servers):
    """Each client with its own server: the same payloads; the JAX
    package's server refuses its own Deneb and Electra payloads (it drops
    the parent beacon block root the block hash commits to), the port's
    accepts them (ROADMAP §3, a reference defect)."""
    _, jax_srv = servers(JAX)
    _, port_srv = servers(PORT)
    jax_own = _drive_engine(jax_http.HttpEngineClient(jax_srv.url, SECRET, JAX.T, timeout=TIMEOUT), JAX)
    port_own = _drive_engine(port_http.HttpEngineClient(port_srv.url, SECRET, PORT.T, timeout=TIMEOUT), PORT)
    assert [o[1] for o in port_own[:4]] == [o[1] for o in jax_own[:4]]
    assert [o[2] for o in port_own[:4]] == ["VALID"] * 4
    assert [o[2] for o in jax_own[:4]] == ["VALID", "VALID", "INVALID", "INVALID"]


def test_wrong_secret_is_refused_by_both_servers(servers):
    _, jax_srv = servers(JAX)
    _, port_srv = servers(PORT)
    fc = (b"\x00" * 32,) * 3
    for pkg, srv in ((PORT, jax_srv), (JAX, port_srv)):
        bad = pkg.http.HttpEngineClient(srv.url, b"\x02" * 32, pkg.T, timeout=TIMEOUT)
        with pytest.raises(pkg.el.ExecutionLayerError, match="HTTP 401"):
            bad.notify_forkchoice_updated(pkg.el.ForkchoiceState(*fc), None)


# -- the watchdog ----------------------------------------------------------------


def _gauge(pkg) -> float:
    return pkg.metrics.REGISTRY.gauge("execution_engine_online").value()


def _transitions(pkg) -> float:
    return pkg.metrics.REGISTRY.counter("execution_engine_offline_transitions_total").value()


def _watchdog_cycle(pkg, servers):
    engine, srv = servers(pkg)
    client = pkg.http.HttpEngineClient(srv.url, SECRET, pkg.T, timeout=TIMEOUT)
    wd = pkg.watchdog.EngineWatchdog(client, upcheck_interval=3600.0)
    attrs = pkg.el.PayloadAttributes(timestamp=6, prev_randao=b"\x07" * 32)
    fork = pkg.F("bellatrix")
    base = _transitions(pkg)
    log = []

    def record(what, fn):
        try:
            res = fn()
            err = None
        except pkg.el.ExecutionLayerError as e:
            res, err = None, (type(e).__name__, "offline" in str(e))
        log.append((what, err, wd.state.value, _gauge(pkg), _transitions(pkg) - base, res))

    record("payload", lambda: bytes(wd.get_payload(None, attrs, fork).block_hash))
    srv.stop()
    record("engine_down", lambda: wd.get_payload(None, attrs, fork))
    record("while_offline", lambda: wd.notify_forkchoice_updated(pkg.el.ForkchoiceState(*(b"\x00" * 32,) * 3), None))
    record("upcheck_down", wd.upcheck)
    _, srv2 = servers(pkg, engine)
    client.url = srv2.url
    record("upcheck_up", wd.upcheck)
    record("payload_again", lambda: bytes(wd.get_payload(None, attrs, fork).block_hash))
    # the guard re-probes by itself once the interval has passed
    srv2.stop()
    record("down_again", lambda: wd.get_payload(None, attrs, fork))
    _, srv3 = servers(pkg, engine)
    client.url = srv3.url
    wd.UPCHECK_INTERVAL_S = 0.0
    record("guard_reprobe", lambda: wd.notify_forkchoice_updated(pkg.el.ForkchoiceState(*(b"\x00" * 32,) * 3), None).value)
    return log


def test_watchdog_goes_offline_and_back_like_the_jax_package(servers):
    port = _watchdog_cycle(PORT, servers)
    jax = _watchdog_cycle(JAX, servers)
    assert port == jax
    states = [row[2] for row in port]
    assert states == ["online", "offline", "offline", "offline", "online", "online", "offline", "online"]
    assert [row[3] for row in port] == [1, 0, 0, 0, 1, 1, 0, 1]
    assert port[-1][4] == 2  # two offline transitions


# -- the builder -------------------------------------------------------------------


def _bids(pkg):
    el = pkg.el.MockExecutionLayer(pkg.T, pkg.E)
    builder = pkg.builder.MockBuilder(el, pkg.T, pkg.E, bid_wei=3 * 10**17)
    pubkey = b"\xaa" * 48
    out = [builder.get_header(1, None, pubkey)]
    builder.register_validators([pkg.builder.ValidatorRegistration(pubkey=pubkey, fee_recipient=b"\x01" * 20)])
    attrs = pkg.el.PayloadAttributes(timestamp=24, prev_randao=b"\x05" * 32, suggested_fee_recipient=b"\x01" * 20)
    bids = [builder.get_header(slot, None, pubkey, attributes=attrs if slot == 2 else None) for slot in (1, 2)]
    payloads = []
    for bid in bids:
        blinded = SimpleNamespace(message=SimpleNamespace(body=SimpleNamespace(execution_payload_header=bid.header)))
        payloads.append(builder.submit_blinded_block(blinded).serialize())
    out += [(b.header.serialize(), b.value_wei, b.pubkey) for b in bids] + payloads
    unknown = SimpleNamespace(message=SimpleNamespace(body=SimpleNamespace(execution_payload_header=pkg.T.ExecutionPayloadHeaderCapella())))
    with pytest.raises(RuntimeError, match="unknown payload"):
        builder.submit_blinded_block(unknown)
    return out


def test_mock_builder_bids_equal():
    port = _bids(PORT)
    assert port == _bids(JAX)
    assert port[0] is None and port[1][1] == 3 * 10**17


# -- the monitoring push --------------------------------------------------------------


class _Receiver:
    """A local HTTP endpoint that keeps each pushed body."""

    def __init__(self):
        bodies = self.bodies = []

        class _H(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                bodies.append(self.rfile.read(int(self.headers.get("Content-Length", 0))))
                self.send_response(200)
                self.end_headers()

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), _H)
        self.url = f"http://127.0.0.1:{self.server.server_port}/api/v1/client/metrics"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def receiver():
    r = _Receiver()
    yield r
    r.stop()


HEALTH = dict(
    cpu_cores=8, total_memory_bytes=64 << 30, free_memory_bytes=12 << 30, disk_bytes_total=1 << 40,
    disk_bytes_free=1 << 39, network_bytes_sent=12345, network_bytes_received=67890,
)


@pytest.mark.parametrize("parts", ["system", "validator", "beaconnode_and_validator"])
def test_monitoring_push_equal(monkeypatch, receiver, parts):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_123.456)
    store = SimpleNamespace(pubkeys=lambda: [b"\x01" * 48, b"\x02" * 48, b"\x03" * 48])
    chain = SimpleNamespace(head_state=SimpleNamespace(slot=77))
    for pkg in (PORT, JAX):
        monkeypatch.setattr(pkg.monitoring, "system_health", lambda: SimpleNamespace(**HEALTH))
        svc = pkg.monitoring.MonitoringService(
            receiver.url,
            chain=chain if parts == "beaconnode_and_validator" else None,
            validator_store=store if parts != "system" else None,
            sender=pkg.monitoring.default_sender,
        )
        svc.send()
    assert len(receiver.bodies) == 2
    port, jax = (json.loads(b) for b in receiver.bodies)
    assert port == jax
    assert [r["process"] for r in port] == {"system": ["system"], "validator": ["validator"], "beaconnode_and_validator": ["beaconnode", "validator"]}[parts]
    assert port[0]["timestamp"] == 1_700_000_123_456 and port[0]["cpu_cores"] == 8


def test_monitoring_failed_push_is_contained_in_both():
    for pkg in (PORT, JAX):

        def boom(endpoint, payload):
            raise ConnectionError("refused")

        pkg.monitoring.MonitoringService("http://127.0.0.1:1/x", sender=boom).send()  # no raise
