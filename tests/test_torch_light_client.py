"""The port's light client (light_client/__init__.py) against the JAX
package on the same seeded inputs.

Minimal preset with Altair from genesis, 64 interop validators, the CPU
device. Under `fake_crypto` on both sides: both harnesses extend 40 slots
alike; the bootstrap of every block's state and the update that each
block's sync aggregate signs are byte-equal; the verdicts of
`initialize_light_client_store` and `process_light_client_update` are
equal on the real objects and on copies with a tampered
current-sync-committee branch, finality branch, next-sync-committee branch,
slot order and participation. Under the `host` backend on both sides (the
port's following the CPU device) for 2 slots: a really signed sync
aggregate's update is accepted, and one with a flipped signature byte or
with a signer's bit cleared is refused, alike. The
sync-committee check is one `fast_aggregate_verify` on the host in both
packages. Tolerance: byte equality and equal verdicts (class and message).
"""

from dataclasses import replace
from types import SimpleNamespace

import pytest

from lighthouse_tpu import light_client as jax_lc
from lighthouse_tpu.beacon_chain import harness as jax_harness
from lighthouse_tpu.crypto import bls as jax_bls
from lighthouse_tpu.types import MinimalEthSpec as JaxE
from lighthouse_tpu.types import minimal_spec as jax_minimal_spec
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch import light_client as port_lc
from lighthouse_tpu_torch.beacon_chain import harness as port_harness
from lighthouse_tpu_torch.crypto import bls as port_bls
from lighthouse_tpu_torch.types import MinimalEthSpec as PortE
from lighthouse_tpu_torch.types import minimal_spec as port_minimal_spec

N_VALIDATORS = 64
SLOTS = 40

JAX = SimpleNamespace(name="jax", lc=jax_lc, harness=jax_harness, bls=jax_bls, E=JaxE, spec=jax_minimal_spec)
PORT = SimpleNamespace(name="port", lc=port_lc, harness=port_harness, bls=port_bls, E=PortE, spec=port_minimal_spec)
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


def _harness(side, n=N_VALIDATORS):
    return side.harness.BeaconChainHarness(replace(side.spec(), altair_fork_epoch=0), side.E, validator_count=n)


@pytest.fixture(scope="module")
def chains():
    prev = _settings()
    _fake()
    try:
        out = {}
        for side in SIDES:
            h = _harness(side)
            h.extend_chain(SLOTS)
            out[side.name] = h
        return out
    finally:
        _restore(prev)


def _blocks(h):
    """{slot: (root, signed block)} of the chain's blocks."""
    return {int(s.message.slot): (bytes(r), s) for r, s in h.chain._blocks_by_root.items()}


def _verdict(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — the class and message are compared
        return type(e).__name__, str(e)
    return "ok", out


def _store_view(store):
    """What a LightClientStore holds, as bytes."""
    nxt = store.next_sync_committee
    return (
        store.finalized_header.serialize(),
        store.optimistic_header.serialize() if store.optimistic_header is not None else None,
        type(store.current_sync_committee).serialize_value(store.current_sync_committee),
        type(nxt).serialize_value(nxt) if nxt is not None else None,
    )


def _update_for(side, h, slot):
    """The update that the block at `slot`'s sync aggregate signs (the
    route's construction: attested = the parent, finalized = its
    checkpoint's state)."""
    chain = h.chain
    _, signed = _blocks(h)[slot]
    attested = chain.state_for_block_root(bytes(signed.message.parent_root))
    cp = bytes(attested.finalized_checkpoint.root)
    fin = chain.state_for_block_root(cp) if cp != b"\x00" * 32 else None
    return side.lc.create_update(attested, fin, signed.message.body.sync_aggregate, slot, chain.E), attested


@pytest.mark.parametrize("slot", range(1, SLOTS + 1, 3))
def test_bootstrap_bytes_equal(chains, slot):
    out = {}
    for side in SIDES:
        h = chains[side.name]
        root, _ = _blocks(h)[slot]
        boot = side.lc.create_bootstrap(h.chain.state_for_block_root(root), h.E)
        store = side.lc.initialize_light_client_store(root, boot, h.E)
        out[side.name] = (boot.serialize(), _store_view(store))
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("slot", range(2, SLOTS + 1, 3))
def test_update_bytes_equal(chains, slot):
    out = {side.name: _update_for(side, chains[side.name], slot)[0].serialize() for side in SIDES}
    assert out["port"] == out["jax"]


def _tamper(update, field, index, value):
    items = list(getattr(update, field))
    items[index] = value
    setattr(update, field, items)
    return update


CASES = ("clean", "finality_branch", "next_sync_committee_branch", "slot_order", "no_participation", "bootstrap_branch", "wrong_trusted_root")


def _case_verdicts(side, h, case):
    """Bootstrap from the finalized checkpoint's state, then the update of
    the head block, with `case` applied."""
    chain = h.chain
    E = h.E
    blocks = _blocks(h)
    fin_root = bytes(chain.finalized_checkpoint.root)
    boot = side.lc.create_bootstrap(chain.state_for_block_root(fin_root), E)
    trusted = fin_root
    if case == "bootstrap_branch":
        _tamper(boot, "current_sync_committee_branch", 2, b"\x13" * 32)
    if case == "wrong_trusted_root":
        trusted = b"\x00" * 32
    init = _verdict(lambda: side.lc.initialize_light_client_store(trusted, boot, E))
    if init[0] != "ok":
        return init
    store = init[1]
    head_slot = max(blocks)
    update, _ = _update_for(side, h, head_slot)
    current = head_slot
    if case == "finality_branch":
        _tamper(update, "finality_branch", 3, b"\x14" * 32)
    if case == "next_sync_committee_branch":
        _tamper(update, "next_sync_committee_branch", 1, b"\x15" * 32)
    if case == "slot_order":
        current = 0
    if case == "no_participation":
        agg = update.sync_aggregate
        update.sync_aggregate = type(agg)(sync_committee_bits=[False] * len(agg.sync_committee_bits), sync_committee_signature=agg.sync_committee_signature)
    res = _verdict(
        lambda: side.lc.process_light_client_update(
            store, update, current_slot=current, spec=h.spec, E=E, genesis_validators_root=bytes(chain.genesis_validators_root)
        )
    )
    return res[0], res[1] if res[0] != "ok" else _store_view(res[1])


@pytest.mark.parametrize("case", CASES)
def test_store_verdicts_equal(chains, case):
    out = {side.name: _case_verdicts(side, chains[side.name], case) for side in SIDES}
    assert out["port"] == out["jax"]
    assert (out["port"][0] == "ok") == (case == "clean")


def _signed_verdicts(side):
    """Real signatures (`host`): a 2-slot chain; the head block's sync
    aggregate over its parent, as is, with a flipped byte, and with one
    signer's bit cleared under the same signature."""
    h = _harness(side, 8)
    h.extend_chain(2)
    chain = h.chain
    E = h.E
    blocks = _blocks(h)
    root1, _ = blocks[1]
    boot = side.lc.create_bootstrap(chain.state_for_block_root(root1), E)
    update, _ = _update_for(side, h, 2)
    agg = update.sync_aggregate
    bits = list(agg.sync_committee_bits)
    flipped = bytearray(bytes(agg.sync_committee_signature))
    flipped[10] ^= 1
    short = list(bits)
    short[bits.index(True)] = False
    variants = {
        "clean": agg,
        "flipped": type(agg)(sync_committee_bits=bits, sync_committee_signature=bytes(flipped)),
        "missing_signer": type(agg)(sync_committee_bits=short, sync_committee_signature=agg.sync_committee_signature),
    }
    out = {}
    for name, a in variants.items():
        upd = side.lc.create_update(
            chain.state_for_block_root(root1), None, a, 2, E
        )
        store = side.lc.initialize_light_client_store(root1, boot, E)
        res = _verdict(
            lambda: side.lc.process_light_client_update(
                store, upd, current_slot=2, spec=h.spec, E=E, genesis_validators_root=bytes(chain.genesis_validators_root)
            )
        )
        out[name] = (res[0], res[1] if res[0] != "ok" else _store_view(res[1]), upd.serialize())
    return out


def test_sync_signature_verdicts_equal_under_host():
    jax_bls.set_backend("host")
    port_bls.set_backend(None)
    assert port_bls.backend_name() == "host"
    out = {side.name: _signed_verdicts(side) for side in SIDES}
    assert out["port"] == out["jax"]
    verdicts = {k: v[0] for k, v in out["port"].items()}
    assert verdicts["clean"] == "ok"
    assert verdicts["flipped"] != "ok" and verdicts["missing_signer"] == "LightClientError"
