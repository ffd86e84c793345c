"""The port's BeaconProcessor against the JAX package's.

Both processors take the same work: every item runs exactly once, batched
kinds reach their handler as lists of at most 64, singletons one by one,
and `drain` waits for all of it. They differ on one point, a reference
defect the port repairs (ROADMAP §3): the JAX manager pops a lane as soon
as it holds work, so arrivals during busy workers leave one at a time;
the port's manager pops only for an idle worker, so they coalesce and the
lanes' priority order applies."""

import threading
import time
from types import SimpleNamespace

import pytest

import lighthouse_tpu.beacon_processor as j_bp
import lighthouse_tpu_torch.beacon_processor as p_bp

SIDES = {"jax": SimpleNamespace(bp=j_bp), "port": SimpleNamespace(bp=p_bp)}


class _Gate:
    """A handler that records each call's argument and blocks on an event
    until released."""

    def __init__(self):
        self.calls, self.release = [], threading.Event()
        self.started = threading.Semaphore(0)

    def __call__(self, arg):
        self.calls.append(arg)
        self.started.release()
        self.release.wait(timeout=30)


def _hold_workers(bp, mod, gate: _Gate, n: int = 2) -> None:
    """Occupy `n` workers with one singleton each, blocked on `gate`."""
    for i in range(n):
        bp.submit(mod.WorkType.GOSSIP_BLOCK, f"hold{i}", gate)
    for _ in range(n):
        assert gate.started.acquire(timeout=10)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_every_item_runs_once_batched_kinds_as_lists(side):
    mod = SIDES[side].bp
    bp = mod.BeaconProcessor(num_workers=2, name=f"bp_{side}")
    got, singles, lock = [], [], threading.Lock()

    def batch(items):
        assert isinstance(items, list) and 1 <= len(items) <= mod.MAX_GOSSIP_ATTESTATION_BATCH_SIZE
        with lock:
            got.extend(items)

    def single(item):
        with lock:
            singles.append(item)

    try:
        for i in range(200):
            assert bp.submit(mod.WorkType.GOSSIP_ATTESTATION, i, batch)
            if i % 20 == 0:
                assert bp.submit(mod.WorkType.GOSSIP_VOLUNTARY_EXIT, i, single)
        assert bp.drain(timeout=30)
    finally:
        bp.shutdown()
    assert sorted(got) == list(range(200))
    assert sorted(singles) == list(range(0, 200, 20))


def test_busy_workers_coalesce_attestations_where_the_jax_processor_does_not():
    sizes = {}
    for side in ("jax", "port"):
        mod = SIDES[side].bp
        bp = mod.BeaconProcessor(num_workers=2, name=f"bp_{side}")
        gate, batches = _Gate(), []
        # one handler object: the processor groups a batch by handler identity
        record = batches.append
        try:
            _hold_workers(bp, mod, gate)
            for i in range(100):
                assert bp.submit(mod.WorkType.GOSSIP_ATTESTATION, i, record)
                time.sleep(0.001)
            gate.release.set()
            assert bp.drain(timeout=30)
        finally:
            gate.release.set()
            bp.shutdown()
        assert sorted(i for b in batches for i in b) == list(range(100))
        sizes[side] = sorted(len(b) for b in batches)
    # the port: both workers free, the lane drained 64 then the rest
    assert sizes["port"] == [36, 64]
    # the reference: popped as they came, into the hand-off queue
    assert len(sizes["jax"]) > 10 and max(sizes["jax"]) < 36


def test_busy_workers_keep_the_priority_order():
    mod = p_bp
    bp = mod.BeaconProcessor(num_workers=1, name="bp_priority")
    gate, order = _Gate(), []
    try:
        _hold_workers(bp, mod, gate, n=1)
        bp.submit(mod.WorkType.GOSSIP_VOLUNTARY_EXIT, "exit", order.append)
        bp.submit(mod.WorkType.GOSSIP_ATTESTATION, "att", lambda items: order.extend(items))
        bp.submit(mod.WorkType.GOSSIP_AGGREGATE, "agg", lambda items: order.extend(items))
        bp.submit(mod.WorkType.GOSSIP_BLOCK, "block", order.append)
        gate.release.set()
        assert bp.drain(timeout=30)
    finally:
        gate.release.set()
        bp.shutdown()
    assert order == ["block", "agg", "att", "exit"]
