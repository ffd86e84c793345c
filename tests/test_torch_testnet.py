"""The port's adversarial fleet (`lighthouse_tpu_torch.testing.testnet`) held
to the JAX package's: the fault plane, the oracle and the health block, the
storage lifecycle verbs, and the sync-layer regressions that the fleet's
scenarios flushed out. Each test runs the same seed through both packages
under `fake_crypto` (the JAX tests' own crypto) on the minimal preset,
holds the port to the JAX test's own bounds, and compares what a run of the
JAX package gives identically each time.

`run_fleet` is the scenario files' seam too (`test_torch_testnet_scenarios.py`
for the smoke, the equivocation and the slow regimes, `_eclipse.py`,
`_das.py`, `_late.py`): it runs one scenario runner of one package and
returns its report, the fleet's genesis state roots at boot, every node's
finalized and justified epochs at the end, the fault verbs called with
their arguments and results (the seeded draws), and the deltas of the
fault counters by kind and of the oracle's passes and failures. Each
file's docstring says which of these two runs of the JAX package with one
seed gave alike, and compares those; roots of blocks are never compared,
as they differ between two runs of either package (which attestations a
block packs depends on when gossip reaches each node)."""

import inspect
import json
import time
from dataclasses import replace
from types import SimpleNamespace

import pytest
import torch

import lighthouse_tpu.beacon_processor as j_bp
import lighthouse_tpu.crypto.bls as j_bls
import lighthouse_tpu.metrics as j_metrics
import lighthouse_tpu.network as j_net
import lighthouse_tpu.network.sync as j_sync
import lighthouse_tpu.network.sync.block_lookups as j_bl
import lighthouse_tpu.testing.testnet as j_tn
import lighthouse_tpu.types.chain_spec as j_spec
import lighthouse_tpu.types.eth_spec as j_eth
import lighthouse_tpu_torch.beacon_processor as p_bp
import lighthouse_tpu_torch.crypto.bls as p_bls
import lighthouse_tpu_torch.metrics as p_metrics
import lighthouse_tpu_torch.network as p_net
import lighthouse_tpu_torch.network.sync as p_sync
import lighthouse_tpu_torch.network.sync.block_lookups as p_bl
import lighthouse_tpu_torch.testing.testnet as p_tn
import lighthouse_tpu_torch.types.chain_spec as p_spec
import lighthouse_tpu_torch.types.eth_spec as p_eth
from lighthouse_tpu.beacon_chain.harness import BeaconChainHarness as JaxHarness
from lighthouse_tpu.metrics.server import serve_lighthouse_path as j_serve
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.beacon_chain.harness import BeaconChainHarness as PortHarness
from lighthouse_tpu_torch.metrics.server import serve_lighthouse_path as p_serve

SIDES = {
    "jax": SimpleNamespace(
        tn=j_tn, bls=j_bls, REGISTRY=j_metrics.REGISTRY, spec=j_spec, E=j_eth.MinimalEthSpec,
        net=j_net, sync=j_sync, bl=j_bl, bp=j_bp, Harness=JaxHarness, serve=j_serve,
    ),
    "port": SimpleNamespace(
        tn=p_tn, bls=p_bls, REGISTRY=p_metrics.REGISTRY, spec=p_spec, E=p_eth.MinimalEthSpec,
        net=p_net, sync=p_sync, bl=p_bl, bp=p_bp, Harness=PortHarness, serve=p_serve,
    ),
}
S = 8  # the minimal preset's SLOTS_PER_EPOCH


@pytest.fixture(autouse=True)
def fake_crypto():
    """Both packages' BLS backends set to fake_crypto before each test and
    restored after it, with the port's default device. Testnet.create makes
    the interop keys under the backend set at that moment (fake_crypto's
    pubkeys are not the host's), so this also fixes the fleets' genesis;
    ClientBuilder then sets the nodes' backend process-wide."""
    prev = default_device(), j_bls.backend_name(), p_bls.backend_setting()
    set_default_device("cpu")
    j_bls.set_backend("fake_crypto")
    p_bls.set_backend("fake_crypto")
    yield
    set_default_device(prev[0])
    j_bls.set_backend(prev[1])
    p_bls.set_backend(prev[2])


def altair_spec(side):
    return replace(side.spec.minimal_spec(), altair_fork_epoch=0)


def deneb_spec(side):
    """Deneb from genesis, so blob commitments and the column pipeline are
    live from slot 0 (the JAX tests' `_das_spec`)."""
    return replace(
        side.spec.minimal_spec(),
        altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0, deneb_fork_epoch=0,
    )


def fleet_counters(side) -> dict:
    c = side.REGISTRY.counter
    return {f"fault:{k}": c("testnet_fault_injections_total").value(kind=k) for k in side.tn.FAULT_KINDS} | {
        f"oracle:{r}": c("scenario_invariant_checks_total").value(result=r) for r in ("pass", "fail")
    }


def delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


#: the fault verbs whose arguments and results are the scenario's seeded
#: draws (the lone node, the eclipse victim, the withheld columns, the
#: equivocating proposer)
FAULT_VERBS = ("partition", "heal", "eclipse", "delay_edges_of", "start_flood", "equivocate",
               "withhold_columns", "kill", "restart", "join")


def _plain(v):
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_plain(x) for x in (sorted(v) if isinstance(v, (set, frozenset)) else v)]
    return v if isinstance(v, (int, float, str, bool, type(None))) else type(v).__name__


def run_fleet(name: str, runner: str, das: bool = False, **kwargs) -> dict:
    """Run `runner` of package `name` ("jax" or "port") on the Altair (or,
    with `das`, the Deneb and DasTestnetEthSpec) minimal chain, both
    packages' BLS backends set to fake_crypto first (Testnet.create makes
    its interop keys under the backend of the moment: fake_crypto's pubkeys
    are not the host's, and the genesis follows them) and the port's torch
    on one intra-op thread (its plain KZG versions work on tiny tensors).
    The fleet that Testnet.create boots is kept for reading after its
    shutdown, and every fault verb's arguments and result are logged."""
    side = SIDES[name]
    spec, E = (deneb_spec(side), side.tn.DasTestnetEthSpec) if das else (altair_spec(side), side.E)
    nets, verbs, genesis = [], [], set()
    create = side.tn.Testnet.create.__func__

    def keep(cls, *args, **kw):
        nets.append(create(cls, *args, **kw))
        genesis.update(bytes(n.chain.genesis_state_root) for n in nets[-1].nodes)
        return nets[-1]

    def logged(verb):
        fn = getattr(side.tn.Testnet, verb)

        def call(net, *args, **kw):
            out = fn(net, *args, **kw)
            verbs.append([verb, _plain(args), {k: _plain(v) for k, v in sorted(kw.items())}, _plain(out)])
            return out

        return call

    prev = default_device(), j_bls.backend_name(), p_bls.backend_setting(), torch.get_num_threads()
    set_default_device("cpu")
    j_bls.set_backend("fake_crypto")
    p_bls.set_backend("fake_crypto")
    torch.set_num_threads(1)
    before = fleet_counters(side)
    t0 = time.perf_counter()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(side.tn.Testnet, "create", classmethod(keep))
            for verb in FAULT_VERBS:
                mp.setattr(side.tn.Testnet, verb, logged(verb))
            report = getattr(side.tn, runner)(spec, E, **kwargs)
    finally:
        set_default_device(prev[0])
        j_bls.set_backend(prev[1])
        p_bls.set_backend(prev[2])
        torch.set_num_threads(prev[3])
    (net,) = nets
    chains = [n.chain for n in net.nodes]
    return {
        "report": report,
        "s": time.perf_counter() - t0,
        "genesis_state_roots": genesis,
        "finalized": [int(c.finalized_checkpoint.epoch) for c in chains],
        "justified": [int(c.head_state.current_justified_checkpoint.epoch) for c in chains],
        "counters": delta(before, fleet_counters(side)),
        "fault_verbs": verbs,
    }


def run_both(runner: str, das: bool = False, **kwargs) -> dict:
    return {name: run_fleet(name, runner, das, **kwargs) for name in SIDES}


def assert_same_run(runs: dict, report_keys: tuple, epochs: bool = True) -> None:
    """What two runs of the JAX package with one seed gave alike, equal in
    the port: one interop genesis, the fault verbs with their seeded draws,
    the fault and oracle counters, `report_keys` of the report and, with
    `epochs`, every node's finalized and justified epochs at the end."""
    jax, port = runs["jax"], runs["port"]
    assert len(port["genesis_state_roots"]) == 1
    assert port["genesis_state_roots"] == jax["genesis_state_roots"]
    for key in ("fault_verbs", "counters") + (("finalized", "justified") if epochs else ()):
        assert port[key] == jax[key], key
    assert {k: port["report"][k] for k in report_keys} == {k: jax["report"][k] for k in report_keys}
    assert port["counters"]["oracle:fail"] == 0


def both(fn) -> dict:
    return {name: fn(side) for name, side in SIDES.items()}


# -- the module's surface --------------------------------------------------------


def _public_names(mod) -> dict:
    return {
        n: type(v).__name__
        for n, v in vars(mod).items()
        if (inspect.isfunction(v) or inspect.isclass(v)) and getattr(v, "__module__", None) == mod.__name__
    }


def test_every_class_and_function_has_its_counterpart():
    jax, port = _public_names(j_tn), _public_names(p_tn)
    assert jax and port == jax
    for cls in ("FaultPlane", "TestnetNetworkService", "TestnetNode", "Testnet", "ChainHealthOracle"):
        methods = lambda mod: {n for n, v in vars(getattr(mod, cls)).items() if callable(v) or isinstance(v, (classmethod, staticmethod, property))}
        assert methods(p_tn) == methods(j_tn), cls
    assert p_tn.FAULT_KINDS == j_tn.FAULT_KINDS
    assert p_tn.INTERNAL_ERROR_SERIES == j_tn.INTERNAL_ERROR_SERIES
    assert p_tn.TESTNET_GENESIS_TIME == j_tn.TESTNET_GENESIS_TIME


#: the one deliberate difference: the runners that the card's fleet phase
#: drives take the nodes' BLS backend (and the column scenario its KZG
#: setting), defaulting to what the JAX runners always use
CARD_RUNNER_PARAMS = {
    "run_smoke_scenario": {"bls_backend": "fake_crypto"},
    "run_equivocation_scenario": {"bls_backend": "fake_crypto"},
    "run_column_withholding_scenario": {"bls_backend": "fake_crypto", "kzg": "dev"},
}


def _defaults(fn) -> dict:
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()}


@pytest.mark.parametrize("name", sorted(n for n in _public_names(j_tn) if n.startswith("run_")) + ["Testnet.create"])
def test_defaults_equal_the_jax_package(name):
    get = lambda mod: getattr(mod.Testnet, "create") if name == "Testnet.create" else getattr(mod, name)
    port, jax = _defaults(get(p_tn)), _defaults(get(j_tn))
    extra = CARD_RUNNER_PARAMS.get(name, {})
    assert {k: v for k, v in port.items() if k not in extra} == jax
    assert {k: port[k] for k in extra} == extra
    if name == "Testnet.create":
        assert jax["bls_backend"] == "fake_crypto"


def test_series_registered_at_import():
    """Both packages register the fleet's series at zero on import (the
    JAX package's conftest lists them; the port's registry has them from
    the module alone)."""
    for side in SIDES.values():
        text = side.REGISTRY.expose()
        for kind in side.tn.FAULT_KINDS:
            assert f'testnet_fault_injections_total{{kind="{kind}"}}' in text
        for series in ("testnet_gossip_frames_dropped_total", "testnet_gossip_frames_delayed_total"):
            assert series in text
        for result in ("pass", "fail"):
            assert f'scenario_invariant_checks_total{{result="{result}"}}' in text


# -- fault plane unit surface ------------------------------------------------------


def _plane_script(side) -> list:
    plane = side.tn.FaultPlane()
    seen = []
    for i, name in enumerate(["a", "b", "c", "d"]):
        plane.register(name, "127.0.0.1", 9000 + i)
    seen += [plane.node_for("127.0.0.1", 9001), plane.edge("a", "b")]
    plane.partition(["a", "b"], ["c", "d"])
    seen += [plane.edge("a", "c"), plane.edge("c", "a"), plane.edge("a", "b")]
    seen += [plane.dial_allowed("a", "d"), plane.dial_allowed("a", "b")]
    seen.append(sorted(sorted(c) for c in plane.components(["a", "b", "c", "d"])))
    plane.delay("a", "b", 0.5)
    seen += [plane.edge("a", "b"), plane.edge("b", "a")]
    plane.mute("c", "d")
    seen += [plane.edge("c", "d"), plane.dial_allowed("c", "d")]
    plane.lie_status("d", 64)
    seen.append(plane.status_extra("d"))
    plane.heal()
    seen += [plane.edge("a", "c"), plane.status_extra("d")]
    seen.append(sorted(sorted(c) for c in plane.components(["a", "b", "c", "d"])))
    return seen


def test_fault_plane_verbs_and_components():
    seen = both(_plane_script)
    assert seen["port"] == seen["jax"]
    assert seen["port"] == [
        "b", 0.0, None, None, 0.0, False, True, [["a", "b"], ["c", "d"]],
        0.5, 0.5, None, True, 64, 0.0, 0, [["a", "b", "c", "d"]],
    ]


def test_scenario_seed_env_override(monkeypatch):
    assert p_tn.scenario_seed(42) == j_tn.scenario_seed(42) == 42
    monkeypatch.setenv("LIGHTHOUSE_TPU_SCENARIO_SEED", "777")
    assert p_tn.scenario_seed(42) == j_tn.scenario_seed(42) == 777


def _withhold_script(side) -> list:
    import random

    plane = side.tn.FaultPlane()
    seen = [plane.withhold_columns("n0", 0.75, 16)]
    seen += [plane.withheld_columns("n0") == frozenset(seen[0]), plane.withheld_columns("n1")]
    plane.withhold_columns("n0", 0.0, 16)
    seen.append(plane.withheld_columns("n0"))
    plane.withhold_columns("n0", 0.5, 16)
    plane.heal()
    seen.append(plane.withheld_columns("n0"))
    # the seeded draw a scenario makes
    seen.append(plane.withhold_columns("n2", 0.375, 16, rng=random.Random(6)))
    return seen


def test_fault_plane_withhold_verb():
    seen = both(_withhold_script)
    assert seen["port"] == seen["jax"]
    assert len(seen["port"][0]) == 12 and seen["port"][1] is True
    assert seen["port"][2:5] == [frozenset()] * 3 and len(seen["port"][5]) == 6


# -- /lighthouse/health chain block ------------------------------------------------


def _health_blocks(side) -> list:
    E = side.E
    net = side.tn.Testnet.create(altair_spec(side), E, node_count=2, validator_count=8, seed=9)
    try:
        oracle = side.tn.ChainHealthOracle(net)
        net.run_until_slot(E.SLOTS_PER_EPOCH + 1, start_slot=1)
        out = []
        for node in net.nodes:
            c = oracle.chain_block(node)
            assert c["head_slot"] == int(node.chain.head_state.slot)
            assert c["head_root"] == "0x" + node.chain.head_root.hex()
            assert c["clock_slot"] == E.SLOTS_PER_EPOCH + 1
            assert c["head_lag_slots"] in (0, 1)
            assert c["finalized_epoch"] == int(node.chain.finalized_checkpoint.epoch)
            assert c["finalized_distance_epochs"] >= 0
            assert c["reorgs_total"] == node.chain.reorgs_total
            assert c["max_reorg_depth"] == node.chain.max_reorg_depth
            assert 0.0 <= c["participation_prev_epoch"] <= 1.0
            out.append({k: v for k, v in c.items() if k != "head_root"} | {"genesis": bytes(node.chain.genesis_state_root)})
        return out
    finally:
        net.shutdown()


def test_health_chain_block_served_per_node():
    """Every node's Beacon API serves its own chain block in one health
    GET, with the same keys and, but for the head root, the same values
    in both packages."""
    blocks = both(_health_blocks)
    assert [sorted(b) for b in blocks["port"]] == [sorted(b) for b in blocks["jax"]]
    assert blocks["port"] == blocks["jax"]


def test_health_without_chain_omits_chain_block():
    for side in SIDES.values():
        code, _ctype, body = side.serve("/lighthouse/health")
        assert code == 200
        data = json.loads(body)["data"]
        assert "chain" not in data and "uptime_seconds" in data


# -- directed regressions: SyncService status-poll discipline ----------------------


class _StubClock:
    def __init__(self, slot=0):
        self.slot = slot

    def now(self):
        return self.slot


class _StubChain:
    def __init__(self):
        self.slot_clock = _StubClock()
        self.head_state = SimpleNamespace(slot=0)


class _StubPeer:
    def __init__(self, pid):
        self.peer_id = pid


class _StubManager:
    def __init__(self):
        self.service = SimpleNamespace(chain=_StubChain(), port=0)
        self.polls = 0
        self.candidates = []

    def poll_sync_candidates(self):
        self.polls += 1
        return self.candidates, self.candidates, 0

    def _range_sync(self, serving, target):
        return 0


def _status_polls(side) -> list:
    mgr = _StubManager()
    svc = side.sync.SyncService(mgr, interval=0.01, status_poll_interval=5.0)
    for _ in range(5):
        svc._tick()
    polls = [mgr.polls]
    mgr.service.chain.slot_clock.slot = 10
    for _ in range(3):
        svc._tick()
    return polls + [mgr.polls]


def test_sync_service_skips_status_polls_when_synced():
    polls = both(_status_polls)
    assert polls["port"] == polls["jax"] == [1, 4]


def _backoff_reset(side) -> tuple:
    mgr = _StubManager()
    svc = side.sync.SyncService(mgr, interval=0.01)
    svc._consecutive_failures = 5
    svc._last_serving_ids = {"old-peer"}
    mgr.candidates = [_StubPeer("new-peer")]
    counter = side.REGISTRY.counter("sync_service_backoff_resets_total")
    before = counter.value(reason="new_serving_peer")
    svc._tick()
    return svc._consecutive_failures, counter.value(reason="new_serving_peer") - before


def test_sync_service_backoff_resets_on_new_serving_peer():
    got = both(_backoff_reset)
    assert got["port"] == got["jax"] == (0, 1)


def _wakes(side) -> tuple:
    mgr = _StubManager()
    svc = side.sync.SyncService(mgr, interval=30.0)
    svc.start()
    try:
        first = mgr.polls
        svc.on_peer_connected()
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and mgr.polls == 0:
            time.sleep(0.01)
        return first, mgr.polls >= 1
    finally:
        svc.stop()


def test_sync_service_peer_connected_wakes_sleeping_loop():
    got = both(_wakes)
    assert got["port"] == got["jax"] == (0, True)


# -- directed regression: range sync backtracks on a competing fork ----------------


def _harness(side, slots=0):
    side.bls.set_backend("fake_crypto")
    h = side.Harness(altair_spec(side), side.E, validator_count=16)
    if slots:
        h.extend_chain(slots, attest=False)
    return h


def _backtrack(side) -> dict:
    a = _harness(side)
    a.extend_chain(4, attest=False)
    b = _harness(side)
    na = side.net.NetworkService(a.chain, heartbeat_interval=None).start()
    nb = side.net.NetworkService(
        b.chain, heartbeat_interval=None, sync_config=side.net.SyncConfig(backoff_base_s=0.01, backoff_max_s=0.05)
    ).start()
    try:
        for blk in na.blocks_by_range(1, 4):
            b.slot_clock.set_slot(int(blk.message.slot))
            b.chain.process_block(blk)
        a.extend_chain(12, attest=False)
        b.add_block_at_slot(6)
        forked = b.chain.head_root != a.chain.head_root
        b.slot_clock.set_slot(16)
        peer = nb.connect("127.0.0.1", na.port)
        counter = side.REGISTRY.counter("sync_fork_backtracks_total")
        before = counter.value()
        nb.sync.sync_with(peer)
        alive = nb.peers.get(peer.peer_id)
        return {
            "forked": forked,
            "backtracks": counter.value() - before,
            "imported_competing_head": b.chain.fork_choice.contains_block(a.chain.head_root),
            "peer_kept": alive is not None and not alive.banned and alive.score > -40,
            "head_slot": int(b.chain.head_state.slot),
            "genesis": bytes(b.chain.genesis_state_root),
        }
    finally:
        na.stop()
        nb.stop()


def test_range_sync_backtracks_on_competing_fork():
    got = both(_backtrack)
    assert got["port"] == got["jax"]
    assert got["port"]["forked"] and got["port"]["backtracks"] == 1
    assert got["port"]["imported_competing_head"] and got["port"]["peer_kept"]


# -- the reprocess queue's verdicts (found by the eclipse scenario) -----------------


def _reprocessed_duplicate(side) -> tuple:
    """An attestation held for its unknown block comes back from the
    reprocess queue after the same vote was accepted by another path (after
    a heal the victim imports the honest chain and its gossip at once):
    what the re-fire's duplicate verdict does to the processor's
    internal-error counter."""
    h = _harness(side, slots=2)
    net = side.net.NetworkService(h.chain, heartbeat_interval=None).start()
    errors = side.REGISTRY.counter("beacon_processor_errors_total")
    try:
        att = h.make_unaggregated_attestations(int(h.chain.head_state.slot), h.chain.head_root)[0]
        first = h.chain.process_attestation_batch([att])[0]
        before = sum(errors.values().values())
        net.processor.submit(side.bp.WorkType.UNKNOWN_BLOCK_ATTESTATION, att, net._reprocess_attestation)
        assert net.processor.drain()
        again = h.chain.process_attestation_batch([att])[0]
        return not isinstance(first, Exception), str(again), sum(errors.values().values()) - before
    finally:
        net.stop()


def test_reprocessed_duplicate_is_no_internal_error_where_the_jax_processor_counts_one():
    """The port drops a re-fired attestation's verdict, as the gossip path
    does; the JAX package raises it into the worker, which counts an
    internal error, so its fleet's zero-internal-error invariant failed on
    a routine duplicate after a heal (the JAX eclipse test's flake)."""
    got = both(_reprocessed_duplicate)
    assert got["jax"] == (True, "validator already attested this epoch", 1)
    assert got["port"] == (True, "validator already attested this epoch", 0)


# -- directed regression: lookup rotation spans the whole pool ---------------------


class _LookupCtx:
    """select_peer in list order; only the honest peer serves the root."""

    def __init__(self, honest_id, block):
        self.honest_id = honest_id
        self.block = block

    def select_peer(self, pool, exclude=(), strikes=None):
        for p in pool:
            if p.peer_id not in exclude:
                return p
        return None

    def blocks_by_root(self, peer, roots):
        return [self.block] if peer.peer_id == self.honest_id else []


class _LookupPeers:
    def __init__(self, peers):
        self._peers = peers

    def peers(self):
        return list(self._peers)

    def report(self, peer_id, delta):
        pass


def _negative_cache(side) -> list:
    a = _harness(side, slots=1)
    peers = [_StubPeer(f"p{i}") for i in range(4)]
    lookups = side.bl.BlockLookups(
        SimpleNamespace(peers=_LookupPeers(peers)), _LookupCtx("nobody", None), side.net.SyncConfig(lookup_max_attempts=3)
    )
    lookups.service.chain = a.chain
    lookups.service.reprocess = None
    lookups.service.processor = None
    garbage = b"\x66" * 32

    def wait():
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and lookups.inflight_count():
            time.sleep(0.01)

    seen = [lookups._spawn(garbage, None, kind="single")]
    wait()
    seen += [garbage in lookups._recent_failures, lookups._spawn(garbage, None, kind="single")]
    lookups._recent_failures[garbage] -= side.bl.LOOKUP_NEGATIVE_TTL_S + 1
    seen.append(lookups._spawn(garbage, None, kind="single"))
    wait()
    seen.append(lookups._spawn(garbage, None, kind="single"))
    lookups.peer_connected()
    seen.append(lookups._spawn(garbage, None, kind="single"))
    wait()
    return seen


def test_failed_lookup_root_negative_cached():
    seen = both(_negative_cache)
    assert seen["port"] == seen["jax"] == [True, True, False, True, False, True]


def _rotation(side) -> tuple:
    a = _harness(side, slots=1)
    head_root = a.chain.head_root
    block = a.chain._blocks_by_root[head_root]
    peers = [_StubPeer(f"p{i}") for i in range(6)]
    lookups = side.bl.BlockLookups(
        SimpleNamespace(peers=_LookupPeers(peers)), _LookupCtx("p5", block), side.net.SyncConfig(lookup_max_attempts=3)
    )
    got = lookups._fetch_root(head_root)
    return got is not None and got.message.hash_tree_root() == head_root, bytes(head_root)


def test_lookup_rotation_spans_whole_pool_past_empty_answers():
    got = both(_rotation)
    assert got["port"] == got["jax"] and got["port"][0]


# -- storage lifecycle verbs (kill / restart / join) --------------------------------


def _drive_to_finality(net, start: int, target: int) -> int:
    """Run slots until every live node shares one head and finalizes
    >= target. Returns the last slot driven."""
    slot = start
    fins = []
    for slot in range(start, start + 6 * S):
        net.run_slot(slot)
        heads = {n.chain.head_root for n in net.live_nodes}
        fins = [int(n.chain.finalized_checkpoint.epoch) for n in net.live_nodes]
        if len(heads) == 1 and min(fins) >= target:
            return slot
    raise AssertionError(f"no finality >= {target} within 6 epochs (got {fins})")


def _needs_disk(side) -> str:
    net = side.tn.Testnet.create(altair_spec(side), side.E, node_count=2, validator_count=8, seed=3)
    try:
        with pytest.raises(side.tn.ScenarioFailure, match="disk-backed") as err:
            net.kill("node0")
        return str(err.value)
    finally:
        net.shutdown()


def test_kill_restart_needs_disk_backed_fleet():
    got = both(_needs_disk)
    assert got["port"] == got["jax"]


def _kill_restart(side, tmp) -> dict:
    tmp.mkdir()
    net = side.tn.Testnet.create(altair_spec(side), side.E, node_count=3, validator_count=12, seed=7, db_dir=str(tmp))
    before = fleet_counters(side)
    try:
        oracle = side.tn.ChainHealthOracle(net)
        slot = _drive_to_finality(net, start=1, target=1)
        oracle.check(require_single_head=True, min_finalized_epoch=1, what="pre-kill baseline")
        fin_before = min(int(n.chain.finalized_checkpoint.epoch) for n in net.nodes)
        victim = net.kill("node2")
        killed = (victim.alive, len(net.live_nodes))
        net.run_until_slot(slot + S, start_slot=slot + 1)
        slot += S
        net.restart("node2")
        anchor = int(victim.chain.anchor_slot)
        assert victim.alive and victim.client is not None
        net.settle(timeout=10.0)
        end = _drive_to_finality(net, start=slot + 1, target=fin_before + 1)
        oracle.check(require_single_head=True, min_finalized_epoch=fin_before + 1, what="post-restart")
        return {
            "finality_slot": slot - S,
            "fin_before": fin_before,
            "killed": killed,
            "anchor_slot": anchor,
            "end_slot": end,
            "finalized": [int(n.chain.finalized_checkpoint.epoch) for n in net.nodes],
            "counters": delta(before, fleet_counters(side)),
            "genesis": bytes(net.nodes[0].chain.genesis_state_root),
        }
    finally:
        net.shutdown()


def test_kill_restart_node_resumes_from_store(tmp_path):
    got = {name: _kill_restart(side, tmp_path / name) for name, side in SIDES.items()}
    port = got["port"]
    assert port["killed"] == (False, 2)
    assert port["anchor_slot"] >= S
    assert port["counters"]["fault:kill"] == port["counters"]["fault:restart"] == 1
    for key in ("finality_slot", "fin_before", "killed", "anchor_slot", "genesis", "counters"):
        assert port[key] == got["jax"][key], key


def _join(side, tmp) -> dict:
    tmp.mkdir()
    net = side.tn.Testnet.create(altair_spec(side), side.E, node_count=3, validator_count=12, seed=13, db_dir=str(tmp))
    boots = side.REGISTRY.counter("checkpoint_sync_boots_total")
    before = boots.value()
    try:
        slot = _drive_to_finality(net, start=1, target=1)
        joiner = net.join("node3", checkpoint_from="node0")
        out = {"finality_slot": slot, "alive": joiner.alive, "live": len(net.live_nodes)}
        out["genesis"] = {bytes(n.chain.genesis_state_root) for n in net.nodes if n is not joiner}
        out["anchor_slot"] = int(joiner.chain.anchor_slot)
        out["boots"] = boots.value() - before
        net.settle(timeout=10.0)
        net.run_until_slot(slot + S, start_slot=slot + 1)
        net.wait_for(
            lambda: joiner.chain.head_root == net.node("node0").chain.head_root,
            timeout=20.0, what="joiner follows the live head",
        )
        c = side.tn.ChainHealthOracle(net).chain_block(joiner)
        out["follows"] = c["head_slot"] >= slot
        return out
    finally:
        net.shutdown()


def test_join_node_checkpoint_syncs_into_live_fleet(tmp_path):
    got = {name: _join(side, tmp_path / name) for name, side in SIDES.items()}
    assert got["port"] == got["jax"]
    assert got["port"]["alive"] and got["port"]["live"] == 4 and got["port"]["follows"]
    assert got["port"]["anchor_slot"] >= S and got["port"]["boots"] == 1
    assert len(got["port"]["genesis"]) == 1
