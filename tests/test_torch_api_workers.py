"""The port's Beacon API serving workers (http_api/workers.py) against
its own single-process server and the JAX package's.

Minimal preset with Altair from genesis, 64 interop validators,
`fake_crypto`, the CPU device, 34 slots, as tests/test_torch_http_api.py
builds it. One harness of each package; on the port's chain a
single-process `HttpApiServer` and one with `workers=2` (two processes
forked from the test's, accepting on one public socket). Every GET of
tests/test_torch_http_api.py whose path a worker answers from its
fork-time snapshot goes through the public port: a worker serves it, and
its status, Content-Type and body equal the single-process server's and
the JAX package's.

Forked workers stay off the card: the post-fork reset marks the process
(`device.mark_forked_worker`), a kernel dispatch there raises, and the
worker forwards the request to its parent, counted under
`why="kernel"`. On the CPU this is shown with the SSZ layer's size
thresholds lowered before the fork (so that rooting a state dispatches
K1's plain version) and a dispatch hook on `ops.sha256.resolve_device`
that logs the process of every dispatch that went through: only the
parent's. Then a head change makes the workers stale, and they forward
(`why="stale"`) until rotated. No worker dies (respawns for death 0).
"""

import os
import re
import time
import urllib.request
from dataclasses import replace

import pytest

from lighthouse_tpu.beacon_chain import harness as jax_harness
from lighthouse_tpu.crypto import bls as jax_bls
from lighthouse_tpu.http_api import HttpApiServer as JaxServer
from lighthouse_tpu.types import MinimalEthSpec as JaxE
from lighthouse_tpu.types import minimal_spec as jax_minimal_spec
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.beacon_chain import harness as port_harness
from lighthouse_tpu_torch.crypto import bls as port_bls
from lighthouse_tpu_torch.http_api import HttpApiServer as PortServer
from lighthouse_tpu_torch.http_api.workers import _LOCAL_GET_PREFIXES
from lighthouse_tpu_torch.ops import sha256 as k1
from lighthouse_tpu_torch.ssz import cached_tree_hash, merkle
from lighthouse_tpu_torch.types import MinimalEthSpec as PortE
from lighthouse_tpu_torch.types import minimal_spec as port_minimal_spec
from lighthouse_tpu_torch.utils import sha256_batch
from test_torch_http_api import GET_ROUTES, N_VALIDATORS, SLOTS, _ids, request

LOCAL_ROUTES = [(t, a) for t, a in GET_ROUTES if t.split("?")[0].startswith(_LOCAL_GET_PREFIXES)]


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


def _harness(harness, spec, E):
    h = harness.BeaconChainHarness(replace(spec(), altair_fork_epoch=0), E, validator_count=N_VALIDATORS)
    h.extend_chain(SLOTS)
    h.attest_to_head(int(h.chain.head_state.slot))
    return h


@pytest.fixture(scope="module")
def rig():
    prev = _settings()
    _fake()
    servers = []
    try:
        jax_h = _harness(jax_harness, jax_minimal_spec, JaxE)
        port_h = _harness(port_harness, port_minimal_spec, PortE)
        jax_single = JaxServer(jax_h.chain).start()
        servers.append(jax_single)
        single = PortServer(port_h.chain).start()
        servers.append(single)
        tier = PortServer(port_h.chain, workers=2)
        tier._pool.respawn_min_interval = 0.05
        tier.start()
        servers.append(tier)
        yield {"jax_h": jax_h, "port_h": port_h, "jax_single": jax_single, "single": single, "tier": tier}
    finally:
        for srv in reversed(servers):
            srv.stop()
        _restore(prev)


def _headers(port, path, accept=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    if accept:
        req.add_header("Accept", accept)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return dict(r.headers)
    except urllib.error.HTTPError as e:
        return dict(e.headers)


def _metric(tier, name, **labels):
    """The merged value of one series in the tier's /metrics (0 if absent)."""
    text = request(tier.parent_port, "/metrics")[3].decode()
    want = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    for line in text.splitlines():
        m = re.match(rf"^{name}\{{(.*)\}} (\S+)$", line)
        if m and ",".join(sorted(m.group(1).split(","))) == want:
            return float(m.group(2))
    return 0.0


def test_local_routes_are_many():
    assert len(LOCAL_ROUTES) > 40
    assert all(not t.startswith(("/eth/v1/node/version", "/eth/v1/validator/")) for t, _ in LOCAL_ROUTES)


@pytest.mark.parametrize("template,accept", LOCAL_ROUTES, ids=[f"{t}|{a or 'json'}" for t, a in LOCAL_ROUTES])
def test_worker_body_equals_single_process(rig, template, accept):
    path = template.format(**_ids(rig["port_h"]))
    got = request(rig["tier"].port, path, accept)
    assert got == request(rig["single"].port, path, accept)
    assert got == request(rig["jax_single"].port, path, accept)
    served = _headers(rig["tier"].port, path, accept)
    assert served["X-Api-Served-By"].startswith("http_api-w"), served


def test_operator_routes_and_posts_forward(rig):
    tier = rig["tier"]
    hdr = _headers(tier.port, "/eth/v1/node/version")
    assert hdr["X-Api-Served-By"] == "parent" and hdr["X-Api-Forwarded-By"].startswith("http_api-w")
    got = request(tier.port, "/eth/v1/beacon/blocks", data=b"{}", content_type="application/json")
    assert got == request(rig["single"].port, "/eth/v1/beacon/blocks", data=b"{}", content_type="application/json")
    assert got[0] == 415


@pytest.fixture
def kernel_tier(rig, tmp_path, monkeypatch):
    """A second tier over the same chain, forked with the size thresholds
    at 1 and a dispatch hook that logs each dispatch's process."""
    log = tmp_path / "dispatches"
    orig = k1.resolve_device

    def hook(device=None):
        dev = orig(device)  # raises in a forked worker: nothing logged
        with open(log, "a") as f:
            f.write(f"{os.getpid()}\n")
        return dev

    monkeypatch.setattr(k1, "resolve_device", hook)
    monkeypatch.setattr(merkle, "_DEVICE_THRESHOLD", 1)
    monkeypatch.setattr(cached_tree_hash, "_DEVICE_BUILD_THRESHOLD", 1)
    monkeypatch.setattr(sha256_batch, "_BATCH_MIN", 1)
    tier = PortServer(rig["port_h"].chain, workers=2).start()
    try:
        yield tier, log
    finally:
        tier.stop()


def test_kernel_dispatch_in_a_worker_is_forwarded_to_the_parent(rig, kernel_tier):
    tier, log = kernel_tier
    state_root = _ids(rig["port_h"])["head_state_root"]
    path = f"/eth/v1/beacon/states/{state_root}/root"
    before = _metric(tier, "api_worker_requests_forwarded_total", why="kernel")
    hdr = _headers(tier.port, path)
    assert hdr["X-Api-Served-By"] == "parent" and hdr["X-Api-Forwarded-By"].startswith("http_api-w")
    got = request(tier.port, path)
    assert got == request(rig["jax_single"].port, path) and got[0] == 200
    pids = set(log.read_text().split())
    assert pids == {str(os.getpid())}
    deadline = time.monotonic() + 10
    while _metric(tier, "api_worker_requests_forwarded_total", why="kernel") < before + 2 and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _metric(tier, "api_worker_requests_forwarded_total", why="kernel") >= before + 2
    # a route that dispatches nothing is still served by the worker
    assert _headers(tier.port, "/eth/v1/beacon/genesis")["X-Api-Served-By"].startswith("http_api-w")


def test_no_worker_died(rig):
    tier = rig["tier"]
    assert _metric(tier, "api_worker_respawns_total", reason="death") == 0
    assert len(tier._pool.worker_info()) == 2


def test_stale_worker_forwards_after_a_head_change(rig):
    """Last: it moves the head."""
    tier, h = rig["tier"], rig["port_h"]
    rig["jax_h"].extend_chain(1)
    h.extend_chain(1)
    time.sleep(2 * tier._pool.heartbeat_interval + 0.1)
    path = "/eth/v1/beacon/headers"
    stale_before = _metric(tier, "api_worker_requests_forwarded_total", why="stale")
    got = request(tier.port, path)
    assert got == request(rig["single"].port, path) == request(rig["jax_single"].port, path)
    deadline = time.monotonic() + 10
    while _metric(tier, "api_worker_requests_forwarded_total", why="stale") <= stale_before and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _metric(tier, "api_worker_requests_forwarded_total", why="stale") > stale_before
    assert _metric(tier, "api_worker_respawns_total", reason="death") == 0
