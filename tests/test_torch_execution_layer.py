"""The port's execution-layer core and chain utilities
(utils/{keccak,rlp,slot_clock,timeout_lock}.py, execution_layer/{__init__,
mock,block_hash}.py) against the JAX package on the same seeded inputs:
keccak-256 digests, RLP bytes and decodes, trie roots, the mock execution
layer's payloads (their bytes and block hashes) and verdicts, the slot
clocks' readings, and the timeout lock's behaviour (who gets the lock,
which acquisitions time out, the error class and message).
Tolerance: exact equality of bytes, values and verdicts."""

import random
import threading
import time
from types import SimpleNamespace

import pytest

from lighthouse_tpu.execution_layer import (
    ForkchoiceState as JaxForkchoiceState,
    MockExecutionLayer as JaxMockEL,
    PayloadAttributes as JaxPayloadAttributes,
)
from lighthouse_tpu.execution_layer import block_hash as jax_block_hash
from lighthouse_tpu.state_processing.bellatrix import NewPayloadRequest as JaxNewPayloadRequest
from lighthouse_tpu.types.chain_spec import ForkName as JaxForkName
from lighthouse_tpu.types.containers import build_types as jax_build_types
from lighthouse_tpu.types.eth_spec import MinimalEthSpec as JaxE
from lighthouse_tpu.utils import keccak as jax_keccak
from lighthouse_tpu.utils import rlp as jax_rlp
from lighthouse_tpu.utils import slot_clock as jax_clock
from lighthouse_tpu.utils import timeout_lock as jax_lock
from lighthouse_tpu_torch.execution_layer import (
    ForkchoiceState as PortForkchoiceState,
    MockExecutionLayer as PortMockEL,
    PayloadAttributes as PortPayloadAttributes,
)
from lighthouse_tpu_torch.execution_layer import block_hash as port_block_hash
from lighthouse_tpu_torch.state_processing.bellatrix import NewPayloadRequest as PortNewPayloadRequest
from lighthouse_tpu_torch.types.chain_spec import ForkName as PortForkName
from lighthouse_tpu_torch.types.containers import build_types as port_build_types
from lighthouse_tpu_torch.types.eth_spec import MinimalEthSpec as PortE
from lighthouse_tpu_torch.utils import keccak as port_keccak
from lighthouse_tpu_torch.utils import rlp as port_rlp
from lighthouse_tpu_torch.utils import slot_clock as port_clock
from lighthouse_tpu_torch.utils import timeout_lock as port_lock

JAX = SimpleNamespace(
    keccak=jax_keccak, rlp=jax_rlp, clock=jax_clock, lock=jax_lock, block_hash=jax_block_hash,
    MockEL=JaxMockEL, Attributes=JaxPayloadAttributes, Request=JaxNewPayloadRequest,
    ForkchoiceState=JaxForkchoiceState, ForkName=JaxForkName, types=jax_build_types(JaxE), E=JaxE,
)
PORT = SimpleNamespace(
    keccak=port_keccak, rlp=port_rlp, clock=port_clock, lock=port_lock, block_hash=port_block_hash,
    MockEL=PortMockEL, Attributes=PortPayloadAttributes, Request=PortNewPayloadRequest,
    ForkchoiceState=PortForkchoiceState, ForkName=PortForkName, types=port_build_types(PortE), E=PortE,
)


def _both(fn):
    """fn(side) for the JAX package and the port; the results equal."""
    jax_out, port_out = fn(JAX), fn(PORT)
    assert port_out == jax_out
    return port_out


@pytest.mark.parametrize("n", [0, 1, 3, 32, 135, 136, 137, 272, 1000, 4096])
def test_keccak256_equal(n):
    data = random.Random(n).randbytes(n)
    out = _both(lambda s: s.keccak.keccak256(data))
    assert len(out) == 32


def _rlp_items(seed: int):
    rng = random.Random(seed)

    def item(depth):
        kind = rng.randrange(4 if depth < 3 else 2)
        if kind == 0:
            return rng.randbytes(rng.choice([0, 1, 1, 2, 55, 56, 300]))
        if kind == 1:
            return rng.choice([0, 1, 127, 128, 255, 256, 2**64 - 1, rng.getrandbits(200)])
        return [item(depth + 1) for _ in range(rng.randrange(5))]

    return [item(0) for _ in range(16)]


@pytest.mark.parametrize("seed", range(4))
def test_rlp_bytes_and_decodes_equal(seed):
    items = _rlp_items(seed)
    encoded = _both(lambda s: [s.rlp.encode(x) for x in items])
    _both(lambda s: [s.rlp.decode(e) for e in encoded])


@pytest.mark.parametrize("count", [0, 1, 2, 17, 128, 300])
def test_ordered_trie_root_equal(count):
    rng = random.Random(count)
    values = [rng.randbytes(rng.randrange(1, 120)) for _ in range(count)]
    _both(lambda s: s.rlp.ordered_trie_root(values))


def test_trie_root_with_shared_prefixes_equal():
    items = {i.to_bytes(4, "big"): b"v%d" % i for i in range(64)}
    items.update({b"\x00\x00" + random.Random(i).randbytes(3): b"w" * i for i in range(1, 40)})
    _both(lambda s: s.rlp.trie_root(items))


def _payload_chain(s):
    """Payloads of the mock execution layer on each fork from Bellatrix,
    each on the last: their bytes, block hashes, verdicts and the block
    hash recomputed by block_hash, plus a tampered and an orphan payload."""
    el = s.MockEL(s.types, s.E)
    out = []
    parent = None
    rng = random.Random(7)
    for i, fork in enumerate(("BELLATRIX", "CAPELLA", "DENEB", "ELECTRA")):
        f = getattr(s.ForkName, fork)
        withdrawals = []
        if fork != "BELLATRIX":
            W = s.types.Withdrawal
            withdrawals = [
                W(index=i * 4 + k, validator_index=rng.randrange(64), address=rng.randbytes(20), amount=rng.randrange(2**40))
                for k in range(3)
            ]
        attrs = s.Attributes(
            timestamp=12 * (i + 1),
            prev_randao=rng.randbytes(32),
            withdrawals=withdrawals,
            suggested_fee_recipient=rng.randbytes(20),
            parent_beacon_block_root=rng.randbytes(32) if fork in ("DENEB", "ELECTRA") else None,
        )
        payload = el.get_payload(parent, attrs, f)
        verdict = el.notify_new_payload(s.Request(payload, parent_beacon_block_root=attrs.parent_beacon_block_root))
        out.append((fork, payload.serialize(), bytes(payload.block_hash), verdict.name))
        parent = bytes(payload.block_hash)
    fc = el.notify_forkchoice_updated(s.ForkchoiceState(parent, parent, b"\x00" * 32), None)
    fake = type(payload)(parent_hash=b"\x77" * 32, block_hash=b"\x88" * 32)
    orphan = type(payload)(parent_hash=b"\x77" * 32)
    orphan.block_hash, _ = s.block_hash.calculate_execution_block_hash(orphan)
    return (
        out,
        fc.name,
        el.notify_new_payload(s.Request(fake)).name,
        el.notify_new_payload(s.Request(orphan)).name,
        bytes(orphan.block_hash),
        bytes(el.generator.terminal_block_hash),
    )


def test_mock_payload_block_hashes_equal():
    out, fc, fake, orphan, _h, _t = _both(_payload_chain)
    assert [v for *_x, v in out] == ["VALID"] * 4
    assert (fc, fake, orphan) == ("VALID", "INVALID", "SYNCING")


def _clock_readings(s, monkeypatch):
    manual = s.clock.ManualSlotClock(genesis_time=1_600_000_000, seconds_per_slot=12)
    out = []
    for slot, into in ((0, 0.0), (5, 3.9), (5, 4.1), (17, 11.5)):
        manual.set_slot(slot)
        manual.set_seconds_into_slot(into)
        out.append((
            manual.now(), manual.slot_start_seconds(slot), manual.seconds_into_slot(),
            manual.slot_offset_seconds(slot - 1), manual.is_past_attestation_deadline(slot),
            manual.is_past_attestation_deadline(slot - 1), manual.attestation_deadline_offset,
        ))
    manual.advance(3)
    out.append(manual.now())
    system = s.clock.SystemTimeSlotClock(genesis_time=1_600_000_000, seconds_per_slot=12)
    for t in (1_500_000_000.0, 1_600_000_000.0, 1_600_000_047.25, 1_600_120_005.5):
        monkeypatch.setattr(s.clock.time, "time", lambda t=t: t)
        out.append((system.now(), system.seconds_into_slot(), system.slot_offset_seconds(3), system.slot_start_seconds(9)))
    monkeypatch.undo()
    return out


def test_slot_clocks_equal(monkeypatch):
    _both(lambda s: _clock_readings(s, monkeypatch))


def _lock_behaviour(s):
    """One scripted run: shared readers, an excluded writer, the writer's
    preference over new readers, idempotent release; what each step got."""
    lk = s.lock.TimeoutRwLock("chain_import", timeout=0.5)
    out = []

    def attempt(fn):
        try:
            fn().release()
            return "acquired"
        except s.lock.LockTimeout as e:
            return type(e).__name__, str(e)

    r1, r2 = lk.acquire_read(), lk.acquire_read()
    out.append(attempt(lambda: lk.acquire_write(timeout=0.05)))
    r1.release()
    r2.release()
    w = lk.acquire_write()
    out.append(attempt(lambda: lk.acquire_read(timeout=0.05)))
    w.release()
    w.release()
    r = lk.acquire_read()
    got = threading.Event()

    def writer():
        with lk.acquire_write(timeout=2.0):
            got.set()

    t = threading.Thread(target=writer)
    t.start()
    time.sleep(0.1)
    out.append(attempt(lambda: lk.acquire_read(timeout=0.05)))
    r.release()
    t.join(timeout=2)
    out.append(got.is_set())
    out.append(attempt(lk.acquire_write))
    return out


def test_timeout_lock_behaviour_equal():
    out = _both(_lock_behaviour)
    assert out[0][0] == out[1][0] == out[2][0] == "LockTimeout"
    assert out[3] is True and out[4] == "acquired"
