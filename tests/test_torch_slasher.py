"""The port's slasher held to the JAX package's (`tests/test_slasher.py`,
`tests/test_slasher_columnar.py`).

Four engines see each stream: the columnar and the reference engine of each
package. Per-cycle stats and the serialized emissions, in order, must be
equal across all four: hostile seeded streams (duplicates, equivocations,
inverted and far-future epochs, sparse validator ids at and above
`RESIDENT_ROWS_CAP`) with the epoch advancing and pruning mid-stream; the
bytes each package's slasher writes to its KV store for the same stream;
restart, reload and the scalar-to-columnar migration. Then the service: its
cycle on a beacon-processor worker once an epoch under competing drivers, a
refused submit, cycles that never overlap, the network's slot tick, the
slashing pooled and in a block; and `bn --slasher` on the CPU."""

import os
import random
import subprocess
import sys
import threading
import time
import urllib.request
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import lighthouse_tpu.beacon_chain.harness as j_harness
import lighthouse_tpu.beacon_processor as j_bp
import lighthouse_tpu.crypto.bls as j_bls
import lighthouse_tpu.metrics as j_metrics
import lighthouse_tpu.network as j_network
import lighthouse_tpu.slasher as j_slasher
import lighthouse_tpu.slasher.columnar as j_columnar
import lighthouse_tpu.slasher.reference as j_reference
import lighthouse_tpu.slasher.service as j_service
import lighthouse_tpu.slasher.spans as j_spans
import lighthouse_tpu.state_processing.accessors as j_acc
import lighthouse_tpu.state_processing.per_block as j_per_block
import lighthouse_tpu.store as j_store
import lighthouse_tpu.types.chain_spec as j_spec
import lighthouse_tpu.types.containers as j_types
import lighthouse_tpu.types.eth_spec as j_eth
import lighthouse_tpu_torch.beacon_chain.harness as p_harness
import lighthouse_tpu_torch.beacon_processor as p_bp
import lighthouse_tpu_torch.crypto.bls as p_bls
import lighthouse_tpu_torch.metrics as p_metrics
import lighthouse_tpu_torch.network as p_network
import lighthouse_tpu_torch.slasher as p_slasher
import lighthouse_tpu_torch.slasher.columnar as p_columnar
import lighthouse_tpu_torch.slasher.reference as p_reference
import lighthouse_tpu_torch.slasher.service as p_service
import lighthouse_tpu_torch.slasher.spans as p_spans
import lighthouse_tpu_torch.state_processing.accessors as p_acc
import lighthouse_tpu_torch.state_processing.per_block as p_per_block
import lighthouse_tpu_torch.store as p_store
import lighthouse_tpu_torch.types.chain_spec as p_spec
import lighthouse_tpu_torch.types.containers as p_types
import lighthouse_tpu_torch.types.eth_spec as p_eth
from lighthouse_tpu_torch import default_device, set_default_device

SIDES = {
    name: SimpleNamespace(
        name=name,
        harness=h,
        bp=bp,
        bls=b,
        REGISTRY=m.REGISTRY,
        network=n,
        slasher=sl,
        columnar=c,
        reference=r,
        service=sv,
        spans=spn,
        acc=acc,
        per_block=pb,
        store=st,
        spec=s,
        T=t.build_types(e.MinimalEthSpec),
        E=e.MinimalEthSpec,
    )
    for name, h, bp, b, m, n, sl, c, r, sv, spn, acc, pb, st, s, t, e in (
        ("jax", j_harness, j_bp, j_bls, j_metrics, j_network, j_slasher, j_columnar, j_reference, j_service, j_spans, j_acc, j_per_block, j_store, j_spec, j_types, j_eth),
        ("port", p_harness, p_bp, p_bls, p_metrics, p_network, p_slasher, p_columnar, p_reference, p_service, p_spans, p_acc, p_per_block, p_store, p_spec, p_types, p_eth),
    )
}
ROOT = Path(__file__).resolve().parent.parent
ENGINES = ("columnar", "reference")
SPE = 8  # minimal SLOTS_PER_EPOCH


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


# -- stream items as plain tuples, built in each package ---------------------------


def _att(side, indices, source, target, root=b"\x01" * 32, head=None):
    T = side.T
    return T.IndexedAttestation(
        attesting_indices=list(indices),
        data=T.AttestationData(
            slot=target * SPE,
            index=0,
            beacon_block_root=head if head is not None else root,
            source=T.Checkpoint(epoch=source, root=b"\x01" * 32),
            target=T.Checkpoint(epoch=target, root=b"\x01" * 32),
        ),
        signature=b"\x00" * 96,
    )


def _header(side, proposer, slot, state_root=b"\x00" * 32):
    T = side.T
    return T.SignedBeaconBlockHeader(
        message=T.BeaconBlockHeader(slot=slot, proposer_index=proposer, parent_root=b"\x11" * 32, state_root=state_root, body_root=b"\x22" * 32),
        signature=b"\x00" * 96,
    )


def _engine(side, kind, history=None, store=None):
    cls = side.columnar.ColumnarSlasher if kind == "columnar" else side.reference.ReferenceSlasher
    cfg = side.slasher.SlasherConfig(history_length=history) if history else None
    return cls(side.E, cfg, store)


def _fingerprint(s):
    """Drained emissions as bytes, in order: the bit-identical unit."""
    atts, props = s.drain_slashings()
    return (
        [(a.attestation_1.serialize(), a.attestation_2.serialize()) for a in atts],
        [(p.signed_header_1.serialize(), p.signed_header_2.serialize()) for p in props],
    )


def _feed(side, s, item):
    kind, args = item
    if kind == "att":
        s.accept_attestation(_att(side, *args))
    else:
        s.accept_block_header(_header(side, *args))


def _random_stream(rng, epoch, n_items, n_validators=40):
    """Hostile mix: sane votes, duplicates, equivocations, inverted
    (target < source), stale and far-future epochs, sparse ids (some at and
    above the resident rows cap), double proposals."""
    cap = p_spans.RESIDENT_ROWS_CAP
    out = []
    for _ in range(n_items):
        if rng.random() < 0.1:
            out.append(("blk", (rng.randrange(0, 3), rng.randrange(epoch * SPE, epoch * SPE + 2), bytes([rng.randrange(0, 3)]) * 32)))
            continue
        src = rng.randrange(0, epoch + 3)
        tgt = rng.randrange(max(0, src - 2), epoch + 4)
        if rng.random() < 0.15:
            tgt = rng.randrange(0, epoch + 4)
        if rng.random() < 0.05:
            src = rng.randrange(0, 2**40)
        idx = [rng.randrange(0, n_validators) for _ in range(rng.randrange(1, 6))]
        if rng.random() < 0.05:
            idx.append(rng.choice([cap, cap + 1, rng.randrange(2**30, 2**45)]))
        out.append(("att", (idx, src, tgt, bytes([rng.randrange(0, 4)]) * 32)))
    return out


def _run_stream(side, kind, cycles, history=12, store=None):
    s = _engine(side, kind, history, store)
    out = []
    for items, epoch in cycles:
        for item in items:
            _feed(side, s, item)
        out.append((s.process_queued(epoch), _fingerprint(s)))
    return out, s


def _cycles(seed, n=12):
    rng = random.Random(seed)
    epoch, cycles = 10, []
    for _ in range(n):
        cycles.append((_random_stream(rng, epoch, rng.randrange(0, 8)), epoch))
        epoch += rng.randrange(0, 3)
    return cycles


@pytest.mark.parametrize("seed", range(6))
def test_hostile_stream_equal_across_four_engines(seed):
    """Per-cycle stats and serialized emissions, in order, bit-identical
    across both packages' columnar and reference engines, with the epoch
    advancing (pruning mid-stream); record state equal after."""
    cycles = _cycles(seed)
    runs = {(name, kind): _run_stream(side, kind, cycles) for name, side in SIDES.items() for kind in ENGINES}
    want = runs[("jax", "reference")][0]
    for key, (got, _) in runs.items():
        assert got == want, key
    assert sum(st["attester_slashings"] for st, _ in want) > 0
    end = cycles[-1][1] + 5
    records = {key: [s.has_attestation_record(v, t) for v in range(40) for t in range(end)] for key, (_, s) in runs.items()}
    assert len({tuple(r) for r in records.values()}) == 1


SCENARIOS = {
    # double vote, then the duplicate that is not slashable
    "double_vote": [([("att", ([1, 2], 0, 5, b"\x01" * 32, b"\x02" * 32)), ("att", ([2, 3], 0, 5, b"\x01" * 32, b"\x03" * 32))], 6)],
    "duplicate": [([("att", ([1], 0, 5)), ("att", ([1], 0, 5))], 6)],
    "new_surrounds_old": [([("att", ([7], 2, 3))], 4), ([("att", ([7], 1, 5))], 6)],
    "old_surrounds_new": [([("att", ([9], 1, 6))], 7), ([("att", ([9], 2, 4))], 7)],
    "double_proposal": [([("blk", (4, 32, b"\xaa" * 32)), ("blk", (4, 32, b"\xbb" * 32)), ("blk", (4, 33, b"\xcc" * 32))], 5)],
    # a relayed equivocation emits once; a third header is a new pair
    "proposal_relay": [
        ([("blk", (4, 32, b"\xaa" * 32)), ("blk", (4, 32, b"\xbb" * 32))], 5),
        ([("blk", (4, 32, b"\xaa" * 32)), ("blk", (4, 32, b"\xbb" * 32)), ("blk", (4, 32, b"\xbb" * 32))], 5),
        ([("blk", (4, 32, b"\xbb" * 32))], 6),
        ([("blk", (4, 32, b"\xcc" * 32))], 6),
    ],
    # history of 4: the epoch-1 record pruned at epoch 100, a late header expired
    "pruning": [([("att", ([1], 0, 1))], 1), ([], 100), ([("blk", (1, 700, b"\xaa" * 32))], 100), ([("blk", (1, 700, b"\xbb" * 32))], 100)],
    # one huge sparse id beside a small conflict
    "sparse_id": [([("att", ([5], 1, 4, b"\x0a" * 32)), ("att", ([5], 1, 4, b"\x0b" * 32)), ("att", ([2**40], 1, 4, b"\x0c" * 32))], 5)],
}


@pytest.mark.parametrize("kind", ENGINES)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_equal(scenario, kind):
    history = 4 if scenario == "pruning" else None
    out = {name: _run_stream(side, kind, SCENARIOS[scenario], history)[0] for name, side in SIDES.items()}
    assert out["port"] == out["jax"]
    found = [(st["attester_slashings"], st["proposer_slashings"]) for st, _ in out["port"]]
    assert found == {
        "double_vote": [(1, 0)],
        "duplicate": [(0, 0)],
        "new_surrounds_old": [(0, 0), (1, 0)],
        "old_surrounds_new": [(0, 0), (1, 0)],
        "double_proposal": [(0, 1)],
        "proposal_relay": [(0, 1), (0, 0), (0, 0), (0, 1)],
        "pruning": [(0, 0)] * 4,
        "sparse_id": [(1, 0)],
    }[scenario]


@pytest.mark.parametrize("kind", ENGINES)
def test_surround_emissions_follow_the_spec_order(kind):
    """attestation_1 surrounds attestation_2, as is_slashable_attestation_data wants."""
    for cycles in (SCENARIOS["new_surrounds_old"], SCENARIOS["old_surrounds_new"]):
        for name, side in SIDES.items():
            s = _engine(side, kind)
            emitted = []
            for items, epoch in cycles:
                for item in items:
                    _feed(side, s, item)
                s.process_queued(epoch)
                emitted += s.drain_slashings()[0]
            (sl,) = emitted
            assert side.acc.is_slashable_attestation_data(sl.attestation_1.data, sl.attestation_2.data), name


def _kv_dump(side, store):
    from_cols = [c for c in side.store.kv.DBColumn if c.name.startswith("SLASHER")]
    return {c.name: [(k, store.get(c, k)) for k in sorted(store.keys(c))] for c in from_cols}


@pytest.mark.parametrize("kind", ENGINES)
def test_kv_bytes_equal(kind):
    """The same stream writes the same keys and values in both packages."""
    cycles = _cycles(7, n=8)
    dumps = {}
    for name, side in SIDES.items():
        store = side.store.MemoryStore()
        _run_stream(side, kind, cycles, store=store)
        dumps[name] = _kv_dump(side, store)
    assert dumps["port"] == dumps["jax"]
    assert any(dumps["port"].values())


def test_restart_resume_equal(tmp_path):
    """Mid-stream restart through a real KV store in both packages: the
    rebuilt engines keep emitting alike."""
    cycles = _cycles(42, n=8)
    out = {}
    for name, side in SIDES.items():
        for kind in ENGINES:
            store = side.store.open_item_store(str(tmp_path / f"{name}-{kind}.db"))
            s, got = _engine(side, kind, 12, store), []
            for i, (items, epoch) in enumerate(cycles):
                if i == 4:
                    s = _engine(side, kind, 12, store)
                for item in items:
                    _feed(side, s, item)
                got.append((s.process_queued(epoch), _fingerprint(s)))
            out[(name, kind)] = got
            store.close()
    assert len({repr(v) for v in out.values()}) == 1


def test_restart_equal_to_unbroken(tmp_path):
    """Conflicts that arrive only after a restart are found exactly as by an
    unbroken engine, in both packages."""
    pre = [("att", ([1, 2, 3], 4, 5, b"\x0a" * 32)), ("att", ([2, 3, 4], 5, 6, b"\x0b" * 32)), ("att", ([9], 3, 7, b"\x0c" * 32))]
    post = [("att", ([2], 5, 6, b"\x1b" * 32)), ("att", ([9], 4, 6, b"\x1c" * 32)), ("att", ([3], 3, 8, b"\x1d" * 32))]
    out = {}
    for name, side in SIDES.items():
        store = side.store.open_item_store(str(tmp_path / f"{name}.db"))
        c, unbroken = _engine(side, "columnar", store=store), _engine(side, "columnar")
        for item in pre:
            _feed(side, c, item)
            _feed(side, unbroken, item)
        assert c.process_queued(7) == unbroken.process_queued(7)
        c2 = _engine(side, "columnar", store=store)
        for item in post:
            _feed(side, c2, item)
            _feed(side, unbroken, item)
        assert c2.process_queued(8) == unbroken.process_queued(8)
        out[name] = _fingerprint(c2)
        assert out[name] == _fingerprint(unbroken) and len(out[name][0]) == 3
        store.close()
    assert out["port"] == out["jax"]


def _rebuilds(side):
    return side.REGISTRY.counter("slasher_span_rebuilds_total").value()


def test_migration_and_reload_equal():
    """A DB written by the reference engine has no span tiles: the columnar
    engine rebuilds them (one rebuild) and detects surrounds both ways; a
    columnar DB reloads from its tiles (no rebuild); a reference interlude
    leaves stale tiles, which the record fingerprint catches; a record
    whose body is gone is dropped. Equal in both packages."""
    out = {}
    for name, side in SIDES.items():
        ms = side.store.MemoryStore()
        r = _engine(side, "reference", store=ms)
        for item in (("att", ([7], 2, 6, b"\x0a" * 32)), ("att", ([9], 3, 5, b"\x0b" * 32))):
            _feed(side, r, item)
        r.process_queued(7)
        no_tiles = ms.keys(side.store.kv.DBColumn.SLASHER_MIN_SPAN) == []
        r0 = _rebuilds(side)
        c = _engine(side, "columnar", store=ms)
        migrated = _rebuilds(side) - r0
        for item in (("att", ([7], 1, 8, b"\x0c" * 32)), ("att", ([9], 4, 4, b"\x0d" * 32))):
            _feed(side, c, item)
        found = c.process_queued(9)
        r0 = _rebuilds(side)
        _engine(side, "columnar", store=ms)
        reload_rebuilds = _rebuilds(side) - r0
        ri = _engine(side, "reference", store=ms)
        _feed(side, ri, ("att", ([1], 2, 9, b"\x0e" * 32)))
        ri.process_queued(9)
        r0 = _rebuilds(side)
        c3 = _engine(side, "columnar", store=ms)
        interlude_rebuilds = _rebuilds(side) - r0
        _feed(side, c3, ("att", ([1], 3, 8, b"\x0f" * 32)))
        interlude = c3.process_queued(9)
        ms2 = side.store.MemoryStore()
        c4 = _engine(side, "columnar", store=ms2)
        _feed(side, c4, ("att", ([5], 1, 4, b"\x0a" * 32)))
        c4.process_queued(5)
        for key in ms2.keys(side.store.kv.DBColumn.SLASHER_INDEXED):
            ms2.delete(side.store.kv.DBColumn.SLASHER_INDEXED, key)
        dangling = [_engine(side, k, store=ms2).has_attestation_record(5, 4) for k in ENGINES]
        out[name] = (no_tiles, migrated, found, reload_rebuilds, interlude_rebuilds, interlude, dangling)
    assert out["port"] == out["jax"]
    assert out["port"] == (True, 1, {"attester_slashings": 2, "proposer_slashings": 0}, 0, 1, {"attester_slashings": 1, "proposer_slashings": 0}, [False, False])


def test_span_tiles_and_data_roots_equal():
    """Dirty span tiles persist with the same keys and bytes; the batched
    attestation data roots equal SSZ's, in both packages."""
    rng = random.Random(0)
    raw = [(rng.randrange(0, 2**40), rng.randrange(0, 2**32), os.urandom(32), rng.randrange(0, 2**50), os.urandom(32), rng.randrange(0, 2**50), os.urandom(32)) for _ in range(65)]
    out = {}
    for name, side in SIDES.items():
        ms = side.store.MemoryStore()
        st = side.spans.SpanStore(kv=ms)
        vals = np.array([1, 2, 300, 5000], dtype=np.int64)
        st.record(vals, 8, 9, current_epoch=10)
        ops = st.flush_ops()
        ms.do_atomically(ops)
        st2 = side.spans.SpanStore(kv=ms)
        same = np.array_equal(st2.gather_min(vals, 7), st.gather_min(vals, 7)) and np.array_equal(st2.gather_max(vals, 7), st.gather_max(vals, 7))
        T = side.T
        datas = [
            T.AttestationData(slot=a, index=b, beacon_block_root=c, source=T.Checkpoint(epoch=d, root=e), target=T.Checkpoint(epoch=f, root=g))
            for a, b, c, d, e, f, g in raw
        ]
        roots = list(side.columnar._attestation_data_roots(datas))
        assert roots == [d.hash_tree_root() for d in datas]
        out[name] = ([(op[0], str(op[1].value), op[2], op[3] if len(op) > 3 else None) for op in ops], same, roots)
    assert out["port"] == out["jax"]
    assert out["port"][1] and sum(1 for op in out["port"][0] if op[0] == "put" and len(op[2]) == 16) == 3


def test_seeded_flood_recall_equal():
    """Planted offenders in an honest 4,096-validator flood: the double vote
    and both surround directions, exactly, in both packages' engines."""
    out = {}
    for name, side in SIDES.items():
        T = side.T

        def flood(source, target, seed):
            rng = np.random.default_rng(seed)
            return [
                T.IndexedAttestation(
                    attesting_indices=np.sort(ch).tolist(),
                    data=T.AttestationData(
                        slot=target * SPE + i % SPE,
                        index=i // SPE,
                        beacon_block_root=b"\x03" * 32,
                        source=T.Checkpoint(epoch=source, root=b"\x01" * 32),
                        target=T.Checkpoint(epoch=target, root=b"\x02" * 32),
                    ),
                    signature=b"\x00" * 96,
                )
                for i, ch in enumerate(np.array_split(rng.permutation(4096), 32))
            ]

        for kind in ENGINES:
            s = _engine(side, kind)
            for a in flood(9, 10, 1) + [_att(side, [200], 8, 13, b"\xaa" * 32), _att(side, [300], 11, 12, b"\xbb" * 32)]:
                s.accept_attestation(a)
            warm = s.process_queued(10)
            warm_fp = _fingerprint(s)
            for a in flood(10, 11, 2) + [_att(side, [100], 10, 11, b"\xcc" * 32), _att(side, [300], 10, 13, b"\xdd" * 32)]:
                s.accept_attestation(a)
            out[(name, kind)] = (warm, warm_fp, s.process_queued(11), _fingerprint(s))
    assert len({repr(v) for v in out.values()}) == 1
    atts = out[("port", "columnar")][3][0]
    assert out[("port", "columnar")][2]["attester_slashings"] == 3 and len(atts) == 3


@pytest.mark.parametrize("kind", ENGINES)
def test_mid_cycle_arrivals_kept(kind):
    out = {}
    for name, side in SIDES.items():
        s = _engine(side, kind)
        late = [_att(side, [5], 0, 3, b"\x0a" * 32), _att(side, [5], 0, 3, b"\x0b" * 32)]
        orig = s._prune

        def prune_and_race(epoch, s=s, late=late, orig=orig):
            s._att_queue.extend(late)
            return orig(epoch)

        s._prune = prune_and_race
        s.accept_attestation(_att(side, [1], 0, 2, b"\x0c" * 32))
        first = s.process_queued(4)
        s._prune = orig
        out[name] = (first, len(s._att_queue), s.process_queued(4))
    assert out["port"] == out["jax"] == ({"attester_slashings": 0, "proposer_slashings": 0}, 2, {"attester_slashings": 1, "proposer_slashings": 0})


def test_factory_and_kill_switch(monkeypatch):
    for side in SIDES.values():
        assert isinstance(side.slasher.Slasher(side.E), side.columnar.ColumnarSlasher)
        monkeypatch.setenv("LIGHTHOUSE_TPU_COLUMNAR_SLASHER", "0")
        assert isinstance(side.slasher.Slasher(side.E), side.reference.ReferenceSlasher)
        monkeypatch.setenv("LIGHTHOUSE_TPU_COLUMNAR_SLASHER", "1")
        assert isinstance(side.slasher.Slasher(side.E), side.columnar.ColumnarSlasher)
    assert p_slasher.DEFAULT_HISTORY_LENGTH == j_slasher.DEFAULT_HISTORY_LENGTH == 4096
    assert (p_spans.UPDATE_WINDOW, p_spans.RESIDENT_ROWS_CAP) == (j_spans.UPDATE_WINDOW, j_spans.RESIDENT_ROWS_CAP)


def test_slasher_series_registered_at_zero():
    names = [
        "slasher_attester_slashings_found",
        "slasher_proposer_slashings_found",
        "slasher_attestations_processed_total",
        "slasher_exact_scans_total",
        "slasher_span_tiles_flushed_total",
        "slasher_span_rebuilds_total",
    ]
    for name in names:
        assert p_metrics.REGISTRY.counter(name) is not None
    for stage in ("slasher_process", "span_gather", "span_compare", "span_update", "persist"):
        assert p_metrics.REGISTRY.histogram(f"trace_span_seconds_{stage}", "") is not None


# -- the service -------------------------------------------------------------------


def _harness(side):
    spec = replace(side.spec.minimal_spec(), altair_fork_epoch=0)
    return side.harness.BeaconChainHarness(spec, side.E, validator_count=16)


def _double_vote(side, svc, validator, target):
    svc.observe_indexed_attestation(_att(side, [validator], target - 1, target, b"\x0a" * 32))
    svc.observe_indexed_attestation(_att(side, [validator], target - 1, target, b"\x0b" * 32))


@pytest.mark.parametrize("side_name", sorted(SIDES))
def test_cycle_runs_on_a_worker_once_an_epoch(side_name):
    """The slot tick submits the cycle on the lowest-priority duty lane; it
    runs on a processor worker exactly once an epoch under competing
    drivers (the port's processor pops only for an idle worker), and the
    slashing is pooled; without a processor it runs inline."""
    side = SIDES[side_name]
    WT = side.bp.WorkType
    assert WT.SLASHER_PROCESS == max(t for t in WT if t is not WT.MIGRATE_STORE)
    h = _harness(side)
    svc = side.service.SlasherService(h.chain)
    proc = side.bp.BeaconProcessor(num_workers=2, name="network_beacon_processor")
    seen = []
    orig = svc.slasher.process_queued
    svc.slasher.process_queued = lambda ep: (seen.append((ep, threading.current_thread().name)), orig(ep))[1]
    _double_vote(side, svc, 3, 1)
    runs = side.REGISTRY.histogram("beacon_processor_work_seconds_slasher_process", "")
    runs0 = runs.count
    drivers = [threading.Thread(target=svc.on_slot, args=(2 * SPE + i % 3,), kwargs={"processor": proc}) for i in range(6)]
    for d in drivers:
        d.start()
    for d in drivers:
        d.join()
    assert proc.drain(timeout=10)
    assert [ep for ep, _ in seen] == [2] and seen[0][1].startswith("network_beacon_processor-w")
    assert runs.count == runs0 + 1
    assert h.chain.op_pool._attester_slashings
    _double_vote(side, svc, 5, 2)
    stats = svc.on_slot(3 * SPE)
    assert stats["attester_slashings"] == 1 and seen[-1] == (3, threading.current_thread().name)
    proc.shutdown()


@pytest.mark.parametrize("side_name", sorted(SIDES))
def test_refused_submit_unclaims_and_cycles_never_overlap(side_name):
    side = SIDES[side_name]
    h = _harness(side)
    svc = side.service.SlasherService(h.chain)
    ran, active, overlaps = [], [], []
    orig = svc.slasher.process_queued

    def slow(epoch):
        active.append(epoch)
        if len(active) > 1:
            overlaps.append(tuple(active))
        ran.append(epoch)
        time.sleep(0.05)
        out = orig(epoch)
        active.remove(epoch)
        return out

    svc.slasher.process_queued = slow
    _double_vote(side, svc, 3, 1)

    class Refusing:
        def submit(self, *a, **kw):
            return False

    assert svc.on_slot(2 * SPE, processor=Refusing()) is None and not ran
    proc = side.bp.BeaconProcessor(num_workers=2, name="network_beacon_processor")
    svc.on_slot(2 * SPE + 1, processor=proc)
    svc.on_slot(3 * SPE, processor=proc)
    assert proc.drain(timeout=10)
    assert ran == [2, 3] and not overlaps and h.chain.op_pool._attester_slashings
    proc.shutdown()


@pytest.mark.parametrize("side_name", sorted(SIDES))
def test_network_slot_tick_submits_the_cycle(side_name):
    side = SIDES[side_name]
    h = _harness(side)
    ns = side.network.NetworkService(h.chain, port=0, heartbeat_interval=None, sync_service_interval=None).start()
    try:
        svc = side.service.SlasherService(h.chain)
        seen = []
        orig = svc.slasher.process_queued
        svc.slasher.process_queued = lambda ep: (seen.append(threading.current_thread().name), orig(ep))[1]
        _double_vote(side, svc, 3, 1)
        h.slot_clock.set_slot(2 * SPE)
        ns.slot_tick()
        assert ns.processor.drain(timeout=10)
        assert seen and seen[0].startswith("network_beacon_processor") and h.chain.op_pool._attester_slashings
    finally:
        ns.stop()


def test_service_slashing_pooled_and_in_a_block_equal():
    """A double vote observed on a live chain: pooled at the epoch tick and
    carried by the next produced block, the same bytes in both packages;
    the produced slashing applies in the state transition."""
    out = {}
    for name, side in SIDES.items():
        h = _harness(side)
        svc = side.service.SlasherService(h.chain)
        assert h.chain.slasher_service is svc
        h.extend_chain(2 * SPE)
        _double_vote(side, svc, 3, 1)
        stats = svc.on_slot(h.chain.head_state.slot + SPE)
        slot = h.chain.head_state.slot + 1
        h.slot_clock.set_slot(slot)
        block, _ = h.chain.produce_block_on_state(slot, h.randao_reveal(0, slot))
        (sl,) = block.body.attester_slashings
        state = h.chain.head_state.copy()
        side.per_block.process_attester_slashing(state, sl, h.spec, side.E, verify_signatures=False)
        out[name] = (stats, sl.serialize(), bool(state.validators[3].slashed))
    assert out["port"] == out["jax"]
    # the validator's own harness vote for epoch 1 conflicts with both
    # planted votes: more than one slashing is found, the block carries one
    assert out["port"][0]["attester_slashings"] >= 1 and out["port"][2]


def test_bn_slasher_starts_and_runs_a_cycle_at_an_epoch_edge():
    """`bn --slasher` (minimal preset, 1-second slots, fake crypto on the
    CPU) starts, and its /metrics show a slasher cycle at each epoch edge
    its clock crosses."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    cmd = [
        sys.executable, "-m", "lighthouse_tpu_torch", "--spec", "minimal", "bn", "--validate", "--slasher",
        "--seconds-per-slot", "1", "--run-for", "12", "--http-port", str(port), "--network-port", "0",
        "--device", "cpu", "--fake-crypto",
    ]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    polls = []
    try:
        deadline = time.monotonic() + 90
        while proc.poll() is None and time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
                    text = r.read().decode()
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/eth/v1/node/syncing", timeout=2) as r:
                    import json

                    sync = json.loads(r.read())["data"]
                cycles = next(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines() if ln.startswith('slasher_process_cycles_total{engine="columnar"}'))
                polls.append((int(sync["head_slot"]) + int(sync["sync_distance"]), cycles))
            except (OSError, ValueError, StopIteration):
                pass
            time.sleep(0.5)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "Traceback" not in out, out[-3000:]
    assert "beacon node up" in out and "bls_backend=fake_crypto" in out
    crossed = [(slot // SPE + 1, c) for slot, c in polls]
    assert crossed and all(e - 1 <= c <= e for e, c in crossed), crossed
    assert max(c for _, c in crossed) >= 2, crossed
