"""The port's BeaconChain and BeaconChainHarness (beacon_chain/chain.py,
harness.py and the modules they import: the store, the slot clock, the op
pool, attestation verification, fork choice) against the JAX package on
the same seeded inputs.

Minimal preset, 64 interop validators, the CPU device. With
`fake_crypto` on both sides: 32 slots of `extend_chain`, compared at every
slot (block, state and head roots, justified and finalized checkpoints);
the gossip rejections of tests/test_beacon_chain.py (future block,
unknown parent, duplicate attestations), compared as error classes and
messages; a reorg by weight; and finality pruning (the snapshot cache,
the split slot and every key of the hot and cold stores). With `host`
crypto on both sides for 2 slots: the roots, a tampered block, a gossip
batch with one bad signature, and a small blob segment with one bad KZG
proof through `process_segment_blob_sidecars`. The port's backend is left
to follow the CPU device (`host`) there; the JAX package's is set.
Tolerance: exact equality of roots, checkpoints, keys and verdicts.
"""

import random
from types import SimpleNamespace

import pytest

from lighthouse_tpu.beacon_chain import harness as jax_harness
from lighthouse_tpu.beacon_chain.data_availability import DataAvailabilityChecker as JaxDA
from lighthouse_tpu.crypto import bls as jax_bls
from lighthouse_tpu.crypto import kzg as jax_kzg
from lighthouse_tpu import state_processing as jax_sp
from lighthouse_tpu.state_processing import accessors as jax_accessors
from lighthouse_tpu.store import DBColumn as JaxDBColumn
from lighthouse_tpu.types import MinimalEthSpec as JaxE
from lighthouse_tpu.types import chain_spec as jax_chain_spec
from lighthouse_tpu.types import minimal_spec as jax_minimal_spec
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch import state_processing as port_sp
from lighthouse_tpu_torch.state_processing import accessors as port_accessors
from lighthouse_tpu_torch.beacon_chain import harness as port_harness
from lighthouse_tpu_torch.beacon_chain.data_availability import DataAvailabilityChecker as PortDA
from lighthouse_tpu_torch.crypto import bls as port_bls
from lighthouse_tpu_torch.crypto import kzg as port_kzg
from lighthouse_tpu_torch.store import DBColumn as PortDBColumn
from lighthouse_tpu_torch.types import MinimalEthSpec as PortE
from lighthouse_tpu_torch.types import chain_spec as port_chain_spec
from lighthouse_tpu_torch.types import minimal_spec as port_minimal_spec

N_VALIDATORS = 64
SLOTS = 32

JAX = SimpleNamespace(
    name="jax", harness=jax_harness, bls=jax_bls, sp=jax_sp, kzg=jax_kzg, DA=JaxDA,
    accessors=jax_accessors, chain_spec=jax_chain_spec,
    DBColumn=JaxDBColumn, E=JaxE, spec=jax_minimal_spec,
)
PORT = SimpleNamespace(
    name="port", harness=port_harness, bls=port_bls, sp=port_sp, kzg=port_kzg, DA=PortDA,
    accessors=port_accessors, chain_spec=port_chain_spec,
    DBColumn=PortDBColumn, E=PortE, spec=port_minimal_spec,
)
SIDES = (JAX, PORT)


@pytest.fixture(autouse=True)
def cpu_device():
    prev = default_device(), jax_bls.backend_name(), port_bls.backend_setting()
    set_default_device("cpu")
    yield
    set_default_device(prev[0])
    jax_bls.set_backend(prev[1])
    port_bls.set_backend(prev[2])


def _fake():
    jax_bls.set_backend("fake_crypto")
    port_bls.set_backend("fake_crypto")


def _host():
    jax_bls.set_backend("host")
    port_bls.set_backend(None)
    assert port_bls.backend_name() == "host"


def _harness(side, n=N_VALIDATORS):
    return side.harness.BeaconChainHarness(side.spec(), side.E, validator_count=n)


def _both(fn):
    """fn(side) for the JAX package and the port; the results equal."""
    jax_out, port_out = fn(JAX), fn(PORT)
    assert port_out == jax_out
    return port_out


def _error(fn):
    """(class name, message) of the exception fn raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class is what is compared
        return type(e).__name__, str(e)
    return None


def _checkpoint(cp):
    return int(cp.epoch), bytes(cp.root)


def _slot_record(h, root):
    chain = h.chain
    return (
        bytes(root),
        bytes(chain.head_root),
        bytes(chain.head_block().message.state_root),
        bytes(chain.head_state.hash_tree_root()),
        _checkpoint(chain.justified_checkpoint),
        _checkpoint(chain.finalized_checkpoint),
    )


@pytest.fixture(scope="module")
def finality_runs():
    """Both harnesses driven 32 slots under fake_crypto, one record a slot."""
    prev = default_device(), jax_bls.backend_name(), port_bls.backend_setting()
    set_default_device("cpu")
    _fake()
    try:
        out = {}
        for side in SIDES:
            h = _harness(side)
            out[side.name] = (h, [_slot_record(h, h.extend_chain(1)[0]) for _ in range(SLOTS)])
        return out
    finally:
        set_default_device(prev[0])
        jax_bls.set_backend(prev[1])
        port_bls.set_backend(prev[2])


@pytest.mark.parametrize("slot", range(1, SLOTS + 1))
def test_extend_chain_roots_and_checkpoints_equal_at_every_slot(finality_runs, slot):
    assert finality_runs["port"][1][slot - 1] == finality_runs["jax"][1][slot - 1]


def test_extend_chain_finalizes_as_the_reference(finality_runs):
    h = finality_runs["port"][0]
    assert (h.justified_epoch, h.finalized_epoch, int(h.chain.head_state.slot)) == (3, 2, 32)


def _proposal(side, h, slot, parent_root=None, graffiti=b"\x00" * 32):
    """A block at `slot` on `parent_root` (the head by default), signed."""
    chain = h.chain
    parent_root = parent_root or chain.head_root
    state = chain.state_at_block_root(parent_root).copy()
    while state.slot < slot:
        side.sp.per_slot_processing(state, h.spec, h.E)
    proposer = side.sp.get_beacon_proposer_index(state, h.E)
    if parent_root == chain.head_root and graffiti == b"\x00" * 32:
        block, _ = chain.produce_block_on_state(slot, h.randao_reveal(proposer, slot, state))
        return h.sign_block(block, state)
    body = chain.types.BeaconBlockBody(
        randao_reveal=h.randao_reveal(proposer, slot, state), eth1_data=state.eth1_data, graffiti=graffiti
    )
    block = chain.types.BeaconBlock(slot=slot, proposer_index=proposer, parent_root=parent_root, state_root=b"\x00" * 32, body=body)
    post = state.copy()
    ctxt = side.sp.ConsensusContext(slot)
    ctxt.set_proposer_index(proposer)
    side.sp.per_block_processing(
        post, chain.types.SignedBeaconBlock(message=block), h.spec, h.E,
        strategy=side.sp.BlockSignatureStrategy.NO_VERIFICATION, ctxt=ctxt, verify_block_root=False,
    )
    block.state_root = post.hash_tree_root()
    return h.sign_block(block, state)


def _gossip_cases(side):
    _fake()
    out = {}
    h = _harness(side)
    h.extend_chain(2)
    chain = h.chain
    slot = int(chain.head_state.slot) + 1
    h.slot_clock.set_slot(slot)
    signed = _proposal(side, h, slot)
    verified = chain.verify_block_for_gossip(signed)
    out["double_proposal"] = _error(lambda: chain.verify_block_for_gossip(signed))
    out["imported"] = bytes(chain.process_block(verified)) == bytes(chain.head_root)
    # a block five slots ahead of the clock
    future = _proposal(side, h, slot + 5)
    out["future"] = _error(lambda: chain.verify_block_for_gossip(future))
    out["future_import"] = _error(lambda: chain.process_block(future))
    t = chain.types
    orphan = t.SignedBeaconBlock(message=t.BeaconBlock(slot=slot, proposer_index=0, parent_root=b"\x77" * 32))
    out["unknown_parent"] = _error(lambda: chain.process_block(orphan))
    # duplicate gossip attestations: accepted once, then each refused
    atts = h.make_unaggregated_attestations(slot, chain.head_root)
    first = chain.process_attestation_batch(atts)
    again = chain.process_attestation_batch(atts)
    out["attestations"] = [None if not isinstance(r, Exception) else (type(r).__name__, str(r)) for r in first]
    out["duplicates"] = [(type(r).__name__, str(r)) for r in again]
    return out


def test_gossip_rejections_equal():
    out = _both(_gossip_cases)
    assert out["imported"] is True
    assert out["double_proposal"][0] == out["future"][0] == out["unknown_parent"][0] == "BlockError"
    assert "future" in out["future"][1] and "parent" in out["unknown_parent"][1]
    assert out["attestations"] == [None] * 8
    assert [c for c, _ in out["duplicates"]] == ["AttestationError"] * 8


def _reorg(side):
    _fake()
    h = _harness(side)
    h.extend_chain(2, attest=False)
    chain = h.chain
    common = chain.head_root
    slot = int(chain.head_state.slot) + 1
    h.slot_clock.set_slot(slot + 1)
    root_a = chain.process_block(_proposal(side, h, slot))
    root_b = chain.process_block(_proposal(side, h, slot, parent_root=common, graffiti=b"\x01" * 32))
    head_before = chain.recompute_head()
    chain.process_attestation_batch(h.make_unaggregated_attestations(slot, root_b))
    return bytes(root_a), bytes(root_b), bytes(head_before), bytes(chain.recompute_head()), chain.reorgs_total


def test_reorg_by_weight_gives_the_same_heads():
    root_a, root_b, _before, head, _reorgs = _both(_reorg)
    assert root_a != root_b and head == root_b


def _store_keys(store, DBColumn):
    return {
        where: {col.name: sorted(bytes(k) for k in kv.keys(col)) for col in DBColumn}
        for where, kv in (("hot", store.hot), ("cold", store.cold))
    }


def _pruning(side):
    _fake()
    h = _harness(side)
    h.extend_chain(8 * 5)
    chain = h.chain
    return (
        h.finalized_epoch,
        sorted(bytes(r) for r in chain._states),
        int(chain.store.split_slot),
        _store_keys(chain.store, side.DBColumn),
    )


def test_finality_prunes_the_same_states_and_keys():
    finalized, states, split, keys = _both(_pruning)
    assert finalized >= 3 and split == finalized * 8
    assert keys["cold"]["BEACON_BLOCK"]


# -- host crypto ----------------------------------------------------------------


def _resigned(side, h, att, slot):
    """att with its signature replaced by a valid signature of another
    message: its one signer's over the same data voting for another root."""
    t = h.chain.types
    data = t.AttestationData(
        slot=att.data.slot, index=att.data.index, beacon_block_root=b"\x99" * 32,
        source=att.data.source, target=att.data.target,
    )
    state = h.chain.head_state
    domain = side.accessors.get_domain(state, side.chain_spec.Domain.BEACON_ATTESTER, int(att.data.target.epoch), h.spec, h.E)
    root = side.chain_spec.compute_signing_root(data.hash_tree_root(), domain)
    cc = side.accessors.committee_cache_at(state, slot // h.E.SLOTS_PER_EPOCH, h.E)
    signer = cc.committee(slot, int(att.data.index))[list(att.aggregation_bits).index(True)]
    return t.Attestation(aggregation_bits=att.aggregation_bits, data=att.data, signature=h._sign(signer, root))


def _host_cases(side):
    _host()
    h = _harness(side)
    roots = h.extend_chain(2)
    chain = h.chain
    out = {
        "roots": [bytes(r) for r in roots],
        "head_state_root": bytes(chain.head_state.hash_tree_root()),
        "backend": side.bls.backend_name(),
    }
    slot = int(chain.head_state.slot) + 1
    h.slot_clock.set_slot(slot)
    head = bytes(chain.head_root)
    # a block whose attestation carries a valid signature over another message
    signed = _proposal(side, h, slot)
    body = signed.message.body
    att = body.attestations[0]
    other = next(a for a in body.attestations if a.data.hash_tree_root() != att.data.hash_tree_root())
    body.attestations[0] = chain.types.Attestation(aggregation_bits=att.aggregation_bits, data=att.data, signature=other.signature)
    tampered = h.sign_block(signed.message)
    out["tampered_block"] = _error(lambda: chain.process_block(tampered))[0]
    out["head_kept"] = bytes(chain.head_root) == head
    # a gossip batch of 8 with one signature over another message
    atts = h.make_unaggregated_attestations(slot, head)
    atts[3] = _resigned(side, h, atts[3], slot)
    out["batch"] = [
        None if not isinstance(r, Exception) else type(r).__name__
        for r in chain.process_attestation_batch(atts)
    ]
    return out


def test_host_crypto_roots_and_verdicts_equal():
    out = _both(_host_cases)
    assert out["backend"] == "host"
    assert out["tampered_block"] == "BlockError" and out["head_kept"]
    assert out["batch"] == [None, None, None, "AttestationError", None, None, None, None]


FE = 64


def _blob(seed: int) -> bytes:
    rng = random.Random(seed)
    return b"".join(rng.randrange(port_kzg.FR_MODULUS).to_bytes(32, "big") for _ in range(FE))


def _segment(side):
    """A 3-block segment (built as tests/test_chain_segment.py builds one),
    two blobs a block, the second block's second proof swapped for the
    first's; through process_segment_blob_sidecars on a fresh chain."""
    _host()
    src = _harness(side, 8)
    roots = []
    for slot in range(1, 4):
        src.slot_clock.set_slot(slot)
        roots.append(bytes(src.add_block_at_slot(slot)[0]))
        src.attest_to_head(slot)
    kzg = side.kzg.Kzg(side.kzg.TrustedSetup.insecure_dev(FE), device=False)
    by_root = {}
    for b, root in enumerate(roots):
        scs = []
        for i in range(2):
            blob = _blob(100 + 2 * b + i)
            c = kzg.blob_to_kzg_commitment(blob)
            scs.append(SimpleNamespace(index=i, blob=blob, kzg_commitment=c, kzg_proof=kzg.compute_blob_kzg_proof(blob, c)))
        by_root[root] = scs
    by_root[roots[1]][1].kzg_proof = by_root[roots[1]][0].kzg_proof
    dst = _harness(side, 8)
    dst.slot_clock.set_slot(3)
    dst.chain.data_availability_checker = side.DA(kzg, side.E)
    res = dst.chain.process_segment_blob_sidecars(by_root)
    return [(r, None if res[r] is None else (type(res[r]).__name__, str(res[r]))) for r in roots]


def test_blob_segment_with_one_bad_proof_gets_equal_verdicts():
    out = _both(_segment)
    assert [v if v is None else v[0] for _r, v in out] == [None, "InvalidComponentsError", None]


# -- faults closed in modules ported earlier --------------------------------


def _anchor_head(fc_module, finalized_root=None):
    """A proto-array fork choice anchored on a non-genesis block A at
    epoch 10 (its store justified and finalized at 10), then block B on A
    whose state's checkpoints lag (justified 10, finalized 9), as the first
    block after an anchor that no state has finalized yet: the head."""
    A, B = b"\xaa" * 32, b"\xbb" * 32
    fc = fc_module.ProtoArrayForkChoice(
        finalized_root=A, finalized_slot=351, finalized_state_root=b"\x01" * 32, justified_epoch=10, finalized_epoch=10
    )
    fc.on_block(slot=352, root=B, parent_root=A, state_root=b"\x02" * 32, justified_epoch=10, finalized_epoch=9)
    kwargs = {} if finalized_root is None else {"finalized_root": finalized_root}
    return fc.get_head(
        justified_checkpoint_root=A, justified_epoch=10, finalized_epoch=10, justified_state_balances=[32] * 4, **kwargs
    )


def test_a_block_on_a_non_genesis_anchor_becomes_the_head():
    """Fork choice from a non-genesis anchor: the block on the anchor is
    viable because it descends from the store's finalized root (spec
    filter_block_tree), though its state's finalized epoch is below the
    anchor's. The JAX package compares epochs only and keeps the anchor
    as the head (the divergence this port repairs), in the columnar proto
    array and in its scalar oracle alike."""
    from lighthouse_tpu.fork_choice import proto_array as jax_pa
    from lighthouse_tpu_torch.fork_choice import proto_array as port_pa
    from lighthouse_tpu_torch.fork_choice import proto_array_reference as port_ref

    class _RefModule:
        ProtoArrayForkChoice = port_ref.ProtoArrayForkChoiceReference

    assert _anchor_head(port_pa) == b"\xbb" * 32
    assert _anchor_head(port_pa, finalized_root=b"\xaa" * 32) == b"\xbb" * 32
    assert _anchor_head(_RefModule) == b"\xbb" * 32
    assert _anchor_head(jax_pa) == b"\xaa" * 32
    # a node outside the finalized root's subtree stays unviable
    assert _anchor_head(port_pa, finalized_root=b"\xcc" * 32) == b"\xaa" * 32


def test_make_persistent_on_a_persistent_state_is_a_no_op():
    """_make_persistent twice: the second call keeps the persistent lists
    it made (no re-wrap), in both packages, and the roots are unchanged."""
    from lighthouse_tpu.beacon_chain.chain import _make_persistent as jax_mp
    from lighthouse_tpu_torch.beacon_chain.chain import _make_persistent as port_mp

    _fake()
    for side, mp in ((JAX, jax_mp), (PORT, port_mp)):
        state = _harness(side, 16).chain.head_state.copy()
        root = state.hash_tree_root()
        mp(state)
        names = ("balances", "validators", "inactivity_scores", "current_epoch_participation")
        fields = {f: getattr(state, f) for f in names if hasattr(state, f)}
        assert {"balances", "validators"} <= set(fields)
        mp(state)
        assert all(getattr(state, f) is v for f, v in fields.items())
        assert state.hash_tree_root() == root
