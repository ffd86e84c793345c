"""The port's sync engine held to the JAX package's, scenario by scenario.

The JAX package's sync scenarios (a slow peer that times out, a peer that
serves forked batches, a peer that goes dark mid-sync, a flaky peer that
truncates a batch, a stale Status, backfill from a spamming peer, parent
and single-block lookups) run once with a JAX syncing node and once with
a port syncing node. The peers they sync from are the same in both runs:
port nodes serving one port harness chain, the faulty ones the port's
FaultyNetworkService (`lighthouse_tpu_torch.testing.sync_faults`); the
lookups' peers are JAX nodes. Both harnesses make the same chain under
`fake_crypto`, so imports, head roots, counters and peer-score signs must
be equal."""

import time
from dataclasses import replace
from types import SimpleNamespace

import pytest

import lighthouse_tpu.beacon_chain.chain as j_chain
import lighthouse_tpu.beacon_chain.harness as j_harness
import lighthouse_tpu.crypto.bls as j_bls
import lighthouse_tpu.metrics as j_metrics
import lighthouse_tpu.network as j_network
import lighthouse_tpu.network.sync as j_sync
import lighthouse_tpu.store as j_store
import lighthouse_tpu.types as j_types
import lighthouse_tpu.types.chain_spec as j_spec
import lighthouse_tpu.types.eth_spec as j_eth
import lighthouse_tpu.utils.slot_clock as j_clock
import lighthouse_tpu_torch.beacon_chain.chain as p_chain
import lighthouse_tpu_torch.beacon_chain.harness as p_harness
import lighthouse_tpu_torch.crypto.bls as p_bls
import lighthouse_tpu_torch.metrics as p_metrics
import lighthouse_tpu_torch.network as p_network
import lighthouse_tpu_torch.network.sync as p_sync
import lighthouse_tpu_torch.store as p_store
import lighthouse_tpu_torch.types.chain_spec as p_spec
import lighthouse_tpu_torch.types.eth_spec as p_eth
import lighthouse_tpu_torch.utils.slot_clock as p_clock
from lighthouse_tpu_torch.testing.sync_faults import FaultPlan, FaultyNetworkService
from lighthouse_tpu_torch import default_device, set_default_device

SIDES = {
    name: SimpleNamespace(
        name=name, chain=c, harness=h, bls=b, REGISTRY=m.REGISTRY, network=n, sync=s, store=st, spec=sp, E=e.MinimalEthSpec, clock=cl
    )
    for name, c, h, b, m, n, s, st, sp, e, cl in (
        ("jax", j_chain, j_harness, j_bls, j_metrics, j_network, j_sync, j_store, j_spec, j_eth, j_clock),
        ("port", p_chain, p_harness, p_bls, p_metrics, p_network, p_sync, p_store, p_spec, p_eth, p_clock),
    )
}
JAX = SIDES["jax"]
PORT = SIDES["port"]
SLOTS_PER_EPOCH = 8


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
    spec = replace(side.spec.minimal_spec(), altair_fork_epoch=0)
    h = side.harness.BeaconChainHarness(spec, side.E, validator_count=16)
    if slots:
        h.extend_chain(slots, attest=attest)
    return h


def _cfg(side, **overrides):
    kw = dict(backoff_base_s=0.01, backoff_max_s=0.05, chain_timeout_s=30.0, max_parallel_downloads=1)
    kw.update(overrides)
    return side.network.SyncConfig(**kw)


def _counter(side, name, **labels):
    return side.REGISTRY.counter(name).value(**labels)


def _stop(*services):
    for s in services:
        s.stop()


# -- range sync under faults ------------------------------------------------------


def _range_scenario(side, a, plans, cfg=None, extra_slots=0):
    """B of `side` range-syncs from port servers on A's chain, one a plan
    (None = an honest server), in dial order."""
    servers = [FaultyNetworkService(a.chain, p).start() if p else PORT.network.NetworkService(a.chain).start() for p in plans]
    b = _harness(side)
    nb = side.network.NetworkService(b.chain, sync_config=cfg or _cfg(side)).start()
    try:
        b.slot_clock.set_slot(a.chain.head_state.slot + extra_slots)
        peers = [nb.connect("127.0.0.1", s.port) for s in servers]
        retries = _counter(side, "sync_batch_retries_total", chain="range")
        imported = nb.sync.sync_with(peers[0]) if len(peers) == 1 else nb.sync.sync_to_head()
        return {
            "imported": imported,
            "head": bytes(b.chain.head_root),
            "retried": _counter(side, "sync_batch_retries_total", chain="range") > retries,
            "score_signs": [(nb.peers.get(p.peer_id).score > 0) - (nb.peers.get(p.peer_id).score < 0) if nb.peers.get(p.peer_id) else None for p in peers],
            "sync_state": side.REGISTRY.gauge("sync_state").value(),
        }
    finally:
        _stop(*servers, nb)


@pytest.fixture(scope="module")
def chain_a():
    """One port harness chain, 4 epochs, served by every range scenario."""
    prev = default_device(), p_bls.backend_setting()
    set_default_device("cpu")
    p_bls.set_backend("fake_crypto")
    try:
        return _harness(PORT, slots=4 * SLOTS_PER_EPOCH)
    finally:
        set_default_device(prev[0])
        p_bls.set_backend(prev[1])


RANGE = {
    # a slow peer times out and the batch rotates to the honest one
    "slow_peer_times_out": (lambda side: dict(plans=[FaultPlan(delay_s=1.5), None], cfg=_cfg(side, batch_timeout_s=0.75))),
    # a peer serving self-consistent forked batches is downscored and rotated out
    "forked_batches": (lambda side: dict(plans=[FaultPlan(fork_first=100), None])),
    # a peer that goes dark after one request: its batches retry on the second
    "mid_sync_disconnect": (lambda side: dict(plans=[FaultPlan(disconnect_after=1), None])),
    # a lone flaky peer truncates its first batch; the backoff'd retry completes
    "flaky_truncated_batch": (lambda side: dict(plans=[FaultPlan(truncate_first=1)])),
    # a Status two epochs past reality: empty phantom batches, then stalled
    "stale_status": (lambda side: dict(plans=[FaultPlan(stale_status_extra=2 * SLOTS_PER_EPOCH)], extra_slots=2 * SLOTS_PER_EPOCH)),
}


@pytest.mark.parametrize("scenario", sorted(RANGE))
def test_range_sync_scenarios_equal(scenario, chain_a):
    out = {name: _range_scenario(side, chain_a, **RANGE[scenario](side)) for name, side in SIDES.items()}
    assert out["port"] == out["jax"]
    assert out["jax"]["imported"] == 4 * SLOTS_PER_EPOCH
    assert out["jax"]["head"] == bytes(chain_a.chain.head_root)


# -- backfill ----------------------------------------------------------------------


def _backfill_scenario(side, spam: bool):
    """B of `side` boots from a port chain's finalized checkpoint (carried
    across as SSZ) and backfills from an honest or a spamming port peer."""
    h = _harness(PORT, slots=4 * SLOTS_PER_EPOCH, attest=True)
    fin = h.chain.finalized_checkpoint
    t = h.chain.types
    block = h.chain._blocks_by_root[fin.root]
    state = h.chain._justified_state_provider(fin.root).copy()
    if side is not PORT:
        fork = t.fork_of_state(state)
        pt = j_types.build_types(side.E).types_for_fork(fork)
        state = pt.BeaconState.deserialize(state.serialize())
        block = pt.SignedBeaconBlock.deserialize(block.serialize())
    spec = replace(side.spec.minimal_spec(), altair_fork_epoch=0)
    clock = side.clock.ManualSlotClock(genesis_time=state.genesis_time, seconds_per_slot=spec.seconds_per_slot)
    chain_b = side.chain.BeaconChain.from_checkpoint(side.store.HotColdDB(side.store.MemoryStore()), state, block, spec, side.E, clock)
    server = (FaultyNetworkService(h.chain, FaultPlan(fork_first=100)) if spam else PORT.network.NetworkService(h.chain)).start()
    nb = side.network.NetworkService(chain_b, sync_config=_cfg(side, epochs_per_batch=1)).start()
    try:
        clock.set_slot(h.chain.head_state.slot)
        peer = nb.connect("127.0.0.1", server.port)
        failures = _counter(side, "sync_batch_failures_total", chain="backfill")
        first = nb.sync.backfill(peer, max_batches=1)
        rest = nb.sync.backfill(peer)
        r, walked = bytes(block.message.parent_root), []
        while (blk := chain_b.store.get_block(r)) is not None:
            walked.append(r)
            r = bytes(blk.message.parent_root)
        return {
            "first": first,
            "rest": rest,
            "walked": walked,
            "watermark": chain_b.store.get_meta(side.sync.backfill.WATERMARK_KEY),
            "failed": _counter(side, "sync_batch_failures_total", chain="backfill") > failures,
            "score_sign": (nb.peers.get(peer.peer_id).score > 0) - (nb.peers.get(peer.peer_id).score < 0),
        }
    finally:
        _stop(server, nb)


@pytest.mark.parametrize("spam", [False, True], ids=["honest", "spamming"])
def test_backfill_scenarios_equal(spam):
    out = {name: _backfill_scenario(side, spam) for name, side in SIDES.items()}
    assert out["port"] == out["jax"]
    if spam:
        assert out["jax"]["first"] == out["jax"]["rest"] == 0 and out["jax"]["failed"] and out["jax"]["score_sign"] < 0
    else:
        assert 0 < out["jax"]["first"] and len(out["jax"]["walked"]) == out["jax"]["first"] + out["jax"]["rest"] > 8


# -- block lookups ----------------------------------------------------------------


def _parent_lookup_scenario(side):
    """A gossip block 3 deep past B's head: attestations for it park in
    the reprocess queue, the parent lookup walks the ancestry by root, and
    the held attestations drain."""
    a = _harness(JAX, slots=SLOTS_PER_EPOCH)
    b = _harness(side)
    na = JAX.network.NetworkService(a.chain).start()
    nb = side.network.NetworkService(b.chain, sync_config=_cfg(side)).start()
    try:
        b.slot_clock.set_slot(a.chain.head_state.slot)
        peer = nb.connect("127.0.0.1", na.port)
        nb.sync.sync_with(peer)
        signed3 = None
        for _ in range(3):
            _, signed3 = a.add_block_at_slot(a.chain.head_state.slot + 1)
        head_root, tip_slot = bytes(a.chain.head_root), a.chain.head_state.slot
        b.slot_clock.set_slot(tip_slot)
        nb._drop_peer(peer)
        atts = a.make_unaggregated_attestations(tip_slot, head_root)
        before_pool = b.chain.op_pool.num_attestations()
        for att in atts[:2]:
            nb.gossip._deliver(nb.topic_att, a.chain.types.Attestation.serialize_value(att), "test-origin")
        assert nb.processor.drain()
        held = b.chain.op_pool.num_attestations() == before_pool and bool(nb.reprocess._by_block_root)
        nb.connect("127.0.0.1", na.port)
        started = _counter(side, "sync_lookups_started_total", kind="parent")
        drained = _counter(side, "sync_lookup_reprocess_drained_total")
        nb.gossip._deliver(nb.topic_block, signed3.serialize(), "test-origin")
        deadline = time.time() + 20
        while time.time() < deadline and not (
            b.chain.fork_choice.contains_block(head_root) and b.chain.op_pool.num_attestations() > before_pool
        ):
            time.sleep(0.05)
        assert nb.processor.drain()
        return {
            "held_first": held,
            "imported": b.chain.fork_choice.contains_block(head_root),
            "head": bytes(b.chain.head_root),
            "pooled": b.chain.op_pool.num_attestations() - before_pool,
            "lookups": _counter(side, "sync_lookups_started_total", kind="parent") - started,
            "drained": _counter(side, "sync_lookup_reprocess_drained_total") - drained,
            "still_held": bool(nb.reprocess._by_block_root),
        }
    finally:
        _stop(na, nb)


def _single_lookup_scenario(side):
    """The same unknown root flooded from five handlers starts one lookup."""
    a = _harness(JAX, slots=2)
    b = _harness(side)
    na = JAX.network.NetworkService(a.chain).start()
    nb = side.network.NetworkService(b.chain, sync_config=_cfg(side)).start()
    try:
        b.slot_clock.set_slot(a.chain.head_state.slot)
        nb.connect("127.0.0.1", na.port)
        before = _counter(side, "sync_lookups_started_total", kind="single")
        root = bytes(a.chain.head_root)
        started = sum(nb.sync.on_unknown_block_root(root) for _ in range(5))
        deadline = time.time() + 20
        while time.time() < deadline and not b.chain.fork_choice.contains_block(root):
            time.sleep(0.05)
        return {
            "started_at_most_one": started <= 1,
            "imported": b.chain.fork_choice.contains_block(root),
            "lookups": _counter(side, "sync_lookups_started_total", kind="single") - before,
        }
    finally:
        _stop(na, nb)


@pytest.mark.parametrize("scenario", ["parent", "single"])
def test_block_lookup_scenarios_equal(scenario):
    fn = _parent_lookup_scenario if scenario == "parent" else _single_lookup_scenario
    out = {name: fn(side) for name, side in SIDES.items()}
    assert out["port"] == out["jax"]
    assert out["jax"]["imported"] and out["jax"]["lookups"] == 1
    if scenario == "parent":
        assert out["jax"]["held_first"] and out["jax"]["pooled"] > 0 and out["jax"]["drained"] >= 2 and not out["jax"]["still_held"]
