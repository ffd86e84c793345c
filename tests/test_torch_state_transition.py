"""The state transition of lighthouse_tpu_torch against lighthouse_tpu, on
the CPU device: a JAX harness chain imported slot by slot through the
port's per_slot_processing and per_block_processing, a mainnet-preset
block large enough for the columnar attestation pipeline and carrying
withdrawals, a really signed block on the host BLS backend, the shuffle
and committees, and the resident registry-columns epoch against the JAX
package's per-validator reference. Tolerance: exact equality of bytes and
integers."""

import random
from dataclasses import replace

import numpy as np
import pytest

import lighthouse_tpu.types as jax_types
import lighthouse_tpu_torch.types as port_types
from chip_smoke import build_deneb_state
from lighthouse_tpu.beacon_chain.harness import BeaconChainHarness
from lighthouse_tpu.crypto import bls as jax_bls
from lighthouse_tpu.state_processing import accessors as jax_acc
from lighthouse_tpu.state_processing import interop_genesis_state
from lighthouse_tpu.state_processing import per_block_processing as jax_per_block
from lighthouse_tpu.state_processing import per_slot_processing as jax_per_slot
from lighthouse_tpu.state_processing import shuffle as jax_shuffle
from lighthouse_tpu.state_processing.bellatrix import compute_timestamp_at_slot as jax_timestamp_at_slot
from lighthouse_tpu.state_processing.capella import get_expected_withdrawals as jax_expected_withdrawals
from lighthouse_tpu.state_processing.epoch_reference import process_epoch_reference
from lighthouse_tpu.state_processing.per_block import BlockProcessingError as JaxBlockError
from lighthouse_tpu.state_processing.per_block import BlockSignatureStrategy as JaxStrategy
from lighthouse_tpu.state_processing.per_block import BlockSignatureVerifier as JaxVerifier
from lighthouse_tpu.types.chain_spec import ForkName as JF
from lighthouse_tpu.types.chain_spec import mainnet_spec as jax_mainnet_spec
from lighthouse_tpu.types.chain_spec import minimal_spec as jax_minimal_spec
from lighthouse_tpu.types.eth_spec import MinimalEthSpec as JE
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.beacon_chain.chain import _make_persistent
from lighthouse_tpu_torch.crypto import bls as port_bls
from lighthouse_tpu_torch.ops import epoch_sweep as k7
from lighthouse_tpu_torch.state_processing import accessors as port_acc
from lighthouse_tpu_torch.state_processing import attestation_batch as port_att_batch
from lighthouse_tpu_torch.state_processing import shuffle as port_shuffle
from lighthouse_tpu_torch.state_processing import (
    BlockProcessingError,
    BlockSignatureStrategy,
    BlockSignatureVerifier,
    per_block_processing,
    per_slot_processing,
    process_epoch,
)
from lighthouse_tpu_torch.state_processing.epoch_reference import (
    process_epoch_reference as port_process_epoch_reference,
)
from lighthouse_tpu_torch.state_processing.registry_columns import registry_columns_for
from lighthouse_tpu_torch.types.chain_spec import mainnet_spec as port_mainnet_spec
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as port_minimal_spec
from lighthouse_tpu_torch.types.containers import build_types
from lighthouse_tpu_torch.types.convert import state_from_ssz

PE = port_types.preset_from_name("minimal")
FORKS = dict(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0, deneb_fork_epoch=0)
FAR = 2**64 - 1


@pytest.fixture(autouse=True)
def cpu_device_and_backends():
    prev = default_device(), jax_bls.backend_name(), port_bls.backend_setting()
    set_default_device("cpu")
    yield
    set_default_device(prev[0])
    jax_bls.set_backend(prev[1])
    port_bls.set_backend(prev[2])


def _specs(**extra):
    return replace(jax_minimal_spec(), **FORKS, **extra), replace(port_minimal_spec(), **FORKS, **extra)


def _chain_blocks(h) -> list:
    blocks, root = [], h.chain.head_root
    while root in h.chain._blocks_by_root:
        blk = h.chain._blocks_by_root[root]
        blocks.append(blk)
        root = bytes(blk.message.parent_root)
    return blocks[::-1]


def _port_block(signed):
    return build_types(PE).types_for_fork("deneb").SignedBeaconBlock.deserialize(signed.serialize())


def test_harness_chain_roots_equal_every_slot(monkeypatch):
    """Seven epochs of a minimal Deneb chain (every fork at epoch 0) from the
    JAX harness: two attested, then five with no attestations, so the last
    epoch transition runs in the inactivity leak (finality delay above
    MIN_EPOCHS_TO_INACTIVITY_PENALTY = 4 needs the seventh epoch). The port
    starts from the carried-across genesis and imports every block's SSZ
    bytes; after every slot and every block its state root equals the JAX
    package's, and at the end the state bytes are equal."""
    jax_bls.set_backend("fake_crypto")
    port_bls.set_backend("fake_crypto")
    jspec, pspec = _specs()
    h = BeaconChainHarness(jspec, JE, validator_count=32)
    genesis = h.chain.head_state.copy()
    S = JE.SLOTS_PER_EPOCH
    h.extend_chain(2 * S)
    h.extend_chain(5 * S, attest=False)
    blocks = _chain_blocks(h)
    assert len(blocks) == 7 * S

    leak = []
    plain = k7.epoch_sweep_plain

    def watched(*args):
        leak.append(int(args[-1][4]))
        return plain(*args)

    monkeypatch.setattr(k7, "epoch_sweep_plain", watched)
    ps = state_from_ssz(genesis.serialize(), "deneb", PE)
    _make_persistent(ps)
    js = genesis.copy()
    slots = 0
    for signed in blocks:
        while ps.slot < signed.message.slot:
            per_slot_processing(ps, pspec, PE)
            jax_per_slot(js, jspec, JE)
            slots += 1
            assert ps.hash_tree_root() == js.hash_tree_root(), f"slot {ps.slot}"
        per_block_processing(ps, _port_block(signed), pspec, PE, BlockSignatureStrategy.VERIFY_BULK)
        jax_per_block(js, signed, jspec, JE, JaxStrategy.VERIFY_BULK)
        root = ps.hash_tree_root()
        assert root == js.hash_tree_root() == bytes(signed.message.state_root), f"block {ps.slot}"
    assert slots == 7 * S
    # the epoch sweep ran through the kernel's plain version at every
    # boundary but genesis, the last one in the leak
    assert leak[:2] == [0, 0] and leak[-1] == 1 and len(leak) == 6
    assert ps.serialize() == js.serialize() == h.chain.head_state.serialize()
    assert registry_columns_for(ps) is not None


# ---------------------------------------------------------------------------
# A mainnet-preset block: the columnar attestation pipeline and withdrawals
# ---------------------------------------------------------------------------

JM = jax_types.preset_from_name("mainnet")
PM = port_types.preset_from_name("mainnet")
G2_INFINITY = b"\xc0" + bytes(95)
# each case turns at most one of the port's switches to its retained path
_SWITCHES = {
    "default": {},
    "batch_attestations_off": {"LIGHTHOUSE_TPU_BATCH_ATTESTATIONS": "0"},
    "resident_columns_off": {"LIGHTHOUSE_TPU_RESIDENT_COLUMNS": "0"},
}


def _mainnet_prestate(n: int, seed: int):
    """The seeded mainnet Deneb state (JAX types) at the last slot of an
    epoch. The 24 validators after next_withdrawal_validator_index get 0x01
    credentials: every third one exited and withdrawable, the others at the
    maximum effective balance with a balance above it, so the payload
    carries a full sweep of both kinds of withdrawal."""
    js = build_deneb_state(jax_types.build_types(JM), JM, n, seed)
    S = JM.SLOTS_PER_EPOCH
    epoch = js.slot // S + 1
    js.slot = epoch * S - 1
    for k in range(24):
        i = (js.next_withdrawal_validator_index + k) % n
        v = js.validators[i]
        v.withdrawal_credentials = b"\x01" + bytes(11) + bytes([k + 1]) * 20
        if k % 3 == 0:
            v.exit_epoch = epoch - 300
            v.withdrawable_epoch = epoch - 44
        else:
            v.effective_balance = JM.MAX_EFFECTIVE_BALANCE
            js.balances[i] = JM.MAX_EFFECTIVE_BALANCE + 1_000_000 * (k + 1)
    return js


def _mainnet_block(mid, jspec, seed: int):
    """A Deneb block for `mid`'s slot, the third of an epoch, built with
    the JAX package's accessors: one attestation per committee of the two
    slots before the boundary (previous-epoch target) and the two after it
    (current-epoch target), then a second attestation of the second
    committee with other bits, so attesters repeat across attestations;
    about 90% of bits set; random sync-aggregate bits; a payload with the
    expected withdrawals. Signatures are placeholders: both packages run
    NO_VERIFICATION."""
    rng = np.random.default_rng(seed)
    t = jax_types.build_types(JM)
    T = t.types_for_fork("deneb")
    S = JM.SLOTS_PER_EPOCH
    slot = mid.slot
    epoch = slot // S
    committees = [
        (a, i)
        for a in range(slot - 4, slot)
        for i in range(jax_acc.committee_cache_at(mid, a // S, JM).committees_per_slot)
    ]
    committees.append(committees[1])
    atts = []
    for a_slot, index in committees:
        e = a_slot // S
        members = jax_acc.get_beacon_committee(mid, a_slot, index, JM)
        data = t.AttestationData(
            slot=a_slot,
            index=index,
            beacon_block_root=jax_acc.get_block_root_at_slot(mid, a_slot, JM),
            source=mid.current_justified_checkpoint if e == epoch else mid.previous_justified_checkpoint,
            target=t.Checkpoint(epoch=e, root=jax_acc.get_block_root(mid, e, JM)),
        )
        bits = (rng.random(len(members)) < 0.9).tolist()
        atts.append(t.Attestation(aggregation_bits=bits, data=data, signature=G2_INFINITY))
    header = mid.latest_execution_payload_header
    withdrawals = jax_expected_withdrawals(mid, JM)
    payload = T.ExecutionPayload(
        parent_hash=header.block_hash,
        fee_recipient=rng.bytes(20),
        state_root=rng.bytes(32),
        receipts_root=rng.bytes(32),
        logs_bloom=rng.bytes(256),
        prev_randao=jax_acc.get_randao_mix(mid, epoch, JM),
        block_number=header.block_number + 1,
        gas_limit=header.gas_limit,
        gas_used=1_000_000,
        timestamp=jax_timestamp_at_slot(mid, jspec, JM),
        extra_data=rng.bytes(16),
        base_fee_per_gas=header.base_fee_per_gas,
        block_hash=rng.bytes(32),
        transactions=[rng.bytes(200) for _ in range(4)],
        withdrawals=withdrawals,
        blob_gas_used=0,
        excess_blob_gas=0,
    )
    block = T.BeaconBlock(
        slot=slot,
        proposer_index=jax_acc.get_beacon_proposer_index(mid, JM),
        parent_root=mid.latest_block_header.hash_tree_root(),
        state_root=bytes(32),
        body=T.BeaconBlockBody(
            randao_reveal=rng.bytes(96),
            eth1_data=mid.eth1_data,
            graffiti=rng.bytes(32),
            attestations=atts,
            sync_aggregate=t.SyncAggregate(
                sync_committee_bits=(rng.random(JM.SYNC_COMMITTEE_SIZE) < 0.9).tolist(),
                sync_committee_signature=G2_INFINITY,
            ),
            execution_payload=payload,
        ),
    )
    return T.SignedBeaconBlock(message=block, signature=G2_INFINITY)


@pytest.fixture(scope="module")
def mainnet_block_oracle():
    """The JAX package's run on its retained oracle paths (the scalar
    attestation loop, the per-validator snapshot with no resident columns)
    from a 4,096-validator pre-state: the state root after each of three
    slots (the first crosses the epoch boundary), the block, and the
    post-block state bytes and root."""
    jspec = jax_mainnet_spec()
    pre = _mainnet_prestate(4096, seed=21)
    js = pre.copy()
    roots = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIGHTHOUSE_TPU_BATCH_ATTESTATIONS", "0")
        mp.setenv("LIGHTHOUSE_TPU_RESIDENT_COLUMNS", "0")
        for _ in range(3):
            jax_per_slot(js, jspec, JM)
            roots.append(js.hash_tree_root())
        signed = _mainnet_block(js, jspec, seed=22)
        jax_per_block(js, signed, jspec, JM, JaxStrategy.NO_VERIFICATION, verify_block_root=False)
    return {
        "pre": pre.serialize(),
        "roots": roots,
        "block": signed.serialize(),
        "withdrawals": [int(w.amount) for w in signed.message.body.execution_payload.withdrawals],
        "post": js.serialize(),
        "post_root": js.hash_tree_root(),
    }


@pytest.mark.parametrize("switch", list(_SWITCHES))
def test_mainnet_block_equals_jax(switch, monkeypatch, mainnet_block_oracle):
    """The port's per_slot_processing across an epoch boundary and two more
    slots, then per_block_processing of a block with six attestations
    (over 700 attestation rows, past the columnar pipeline's threshold) and
    16 withdrawals, full and partial: the root after every slot and the
    post-block bytes and root equal the JAX oracle's. `default` runs the
    columnar pipeline over resident columns; each other case sets one of
    the port's switches and must give the same state."""
    oracle = mainnet_block_oracle
    for key, value in _SWITCHES[switch].items():
        monkeypatch.setenv(key, value)
    ran, swept = [], []
    for name in ("_process_attestations_columnar", "process_attestations_reference"):
        fn = getattr(port_att_batch, name)
        monkeypatch.setattr(port_att_batch, name, lambda *a, _fn=fn, _name=name: (ran.append(_name), _fn(*a))[1])
    plain = k7.epoch_sweep_plain
    monkeypatch.setattr(k7, "epoch_sweep_plain", lambda *a: (swept.append(1), plain(*a))[1])

    pspec = port_mainnet_spec()
    ps = state_from_ssz(oracle["pre"], "deneb", PM)
    _make_persistent(ps)
    for root in oracle["roots"]:
        per_slot_processing(ps, pspec, PM)
        assert ps.hash_tree_root() == root, f"slot {ps.slot}"
    signed = build_types(PM).types_for_fork("deneb").SignedBeaconBlock.deserialize(oracle["block"])
    assert sum(len(a.aggregation_bits) for a in signed.message.body.attestations) >= port_att_batch._SMALL_BATCH_ROWS
    per_block_processing(ps, signed, pspec, PM, BlockSignatureStrategy.NO_VERIFICATION, verify_block_root=False)
    assert ps.serialize() == oracle["post"]
    assert ps.hash_tree_root() == oracle["post_root"]

    # what the run went through: the kernel's plain version once (the
    # boundary), the attestation path the switch selects, the columns
    full = [a for a in oracle["withdrawals"] if a > 10**9]
    assert len(oracle["withdrawals"]) == PM.MAX_WITHDRAWALS_PER_PAYLOAD and 0 < len(full) < len(oracle["withdrawals"])
    assert swept == [1]
    if switch == "batch_attestations_off":
        assert ran == ["process_attestations_reference"]
    else:
        assert ran == ["_process_attestations_columnar"]
    assert (registry_columns_for(ps) is None) == (switch == "resident_columns_off")


def test_really_signed_block_verdicts_equal():
    """A block signed with the interop keys, verified on the port's host
    BLS backend and the JAX package's: both accept it, both refuse it with
    its RANDAO reveal replaced by another valid signature."""
    jax_bls.set_backend("host")
    port_bls.set_backend("host")
    jspec, pspec = _specs()
    h = BeaconChainHarness(jspec, JE, validator_count=16)
    pre = h.chain.head_state.copy()
    _, signed = h.add_block_at_slot(1)

    js = pre.copy()
    jax_per_slot(js, jspec, JE)
    ps = state_from_ssz(js.serialize(), "deneb", PE)
    _make_persistent(ps)
    pblock = _port_block(signed)

    def verdicts(block_j, block_p):
        jv = JaxVerifier(js, jspec, JE)
        jv.include_all_signatures(block_j, None, None)
        pv = BlockSignatureVerifier(ps, pspec, PE)
        pv.include_all_signatures(block_p, None, None)
        assert len(jv.sets) == len(pv.sets) == 3  # proposal, RANDAO, sync aggregate
        return jv.verify(), pv.verify()

    assert verdicts(signed, pblock) == (True, True)
    bad_j = type(signed).deserialize(signed.serialize())
    bad_j.message.body.randao_reveal = signed.signature
    bad_p = _port_block(bad_j)
    assert verdicts(bad_j, bad_p) == (False, False)

    with pytest.raises(JaxBlockError):
        jax_per_block(js.copy(), bad_j, jspec, JE, JaxStrategy.VERIFY_BULK)
    with pytest.raises(BlockProcessingError):
        per_block_processing(ps.copy(), bad_p, pspec, PE, BlockSignatureStrategy.VERIFY_BULK)
    per_block_processing(ps, pblock, pspec, PE, BlockSignatureStrategy.VERIFY_BULK)
    assert ps.hash_tree_root() == bytes(signed.message.state_root)


@pytest.mark.parametrize("n", [1, 2, 3, 100, 1000, 10_000])
def test_shuffle_equals_jax(n):
    rng = np.random.default_rng(n)
    seed = rng.bytes(32)
    rounds = JE.SHUFFLE_ROUND_COUNT
    assert list(port_shuffle.shuffle_list(list(range(n)), seed, rounds)) == list(
        jax_shuffle.shuffle_list(list(range(n)), seed, rounds)
    )
    assert np.array_equal(
        port_shuffle._shuffled_positions(n, seed, rounds), jax_shuffle._shuffled_positions(n, seed, rounds)
    )
    for i in rng.integers(0, n, 8).tolist():
        assert port_shuffle.compute_shuffled_index(i, n, seed, rounds) == jax_shuffle.compute_shuffled_index(
            i, n, seed, rounds
        )


@pytest.mark.parametrize("preset,n", [("minimal", 0), ("mainnet", 4096)])
def test_committees_and_proposers_equal_jax(preset, n):
    """Committees and proposer indices of the previous, current and next
    epoch: on the harness's genesis state (minimal) and on a seeded
    4,096-validator mainnet state."""
    JEp, PEp = jax_types.preset_from_name(preset), port_types.preset_from_name(preset)
    if n:
        js = build_deneb_state(jax_types.build_types(JEp), JEp, n, seed=4)
    else:
        jax_bls.set_backend("fake_crypto")
        js = BeaconChainHarness(_specs()[0], JE, validator_count=32).chain.head_state.copy()
        js.slot = 3 * JE.SLOTS_PER_EPOCH + 5
    ps = state_from_ssz(js.serialize(), "deneb", PEp)
    epoch = js.slot // JEp.SLOTS_PER_EPOCH
    for e in (epoch - 1, epoch, epoch + 1):
        for slot in range(e * JEp.SLOTS_PER_EPOCH, (e + 1) * JEp.SLOTS_PER_EPOCH):
            count = jax_acc.committee_cache_at(js, e, JEp).committees_per_slot
            assert port_acc.committee_cache_at(ps, e, PEp).committees_per_slot == count
            for index in range(count):
                assert list(port_acc.get_beacon_committee(ps, slot, index, PEp)) == list(
                    jax_acc.get_beacon_committee(js, slot, index, JEp)
                )
    for slot in range(epoch * JEp.SLOTS_PER_EPOCH, (epoch + 1) * JEp.SLOTS_PER_EPOCH):
        assert port_acc.get_beacon_proposer_index(ps, PEp, slot) == jax_acc.get_beacon_proposer_index(
            js, JEp, slot
        )


# ---------------------------------------------------------------------------
# Registry-columns epochs against the JAX per-validator reference
# ---------------------------------------------------------------------------

_FORKS_OF = {
    JF.PHASE0: {},
    JF.ALTAIR: dict(altair_fork_epoch=0),
    JF.ELECTRA: dict(FORKS, electra_fork_epoch=0),
}


def _base_state(fork, n: int, seed: int):
    """A boundary-ready state with a randomized registry: pending, exited,
    slashed validators; participation (altair) or pending attestations
    (phase0); scores, balances and slashings. Electra adds compounding
    validators at effective balances up to 2048 ETH with scores near the
    host guard of the epoch-sweep kernel, and the three pending queues."""
    jax_bls.set_backend("fake_crypto")
    rng = random.Random(seed)
    spec = replace(jax_minimal_spec(), **_FORKS_OF[fork])
    state = interop_genesis_state(jax_bls.interop_keypairs(8), 1_600_000_000, b"\x42" * 32, spec, JE)
    v0 = state.validators[0]
    vs = []
    for i in range(n):
        v = v0.copy()
        v.withdrawal_credentials = bytes([rng.choice([0x00, 0x01])]) + i.to_bytes(31, "little")
        v.effective_balance = rng.choice([32_000_000_000, 31_000_000_000, 16_000_000_000])
        if rng.random() < 0.1:
            v.activation_epoch = FAR
            v.activation_eligibility_epoch = rng.choice([FAR, 0, 1])
        if rng.random() < 0.08:
            v.exit_epoch = rng.randrange(1, 12)
            v.withdrawable_epoch = v.exit_epoch + 256
        if rng.random() < 0.06:
            v.slashed = True
            v.withdrawable_epoch = rng.choice([3 + JE.EPOCHS_PER_SLASHINGS_VECTOR // 2, 40, 300])
        vs.append(v)
    state.validators = vs
    state.balances = [rng.randrange(0, 40_000_000_000) for _ in range(n)]
    if fork >= JF.ALTAIR:
        state.previous_epoch_participation = bytearray(rng.randrange(8) for _ in range(n))
        state.current_epoch_participation = bytearray(rng.randrange(8) for _ in range(n))
        state.inactivity_scores = [rng.randrange(6) for _ in range(n)]
    for s in range(len(state.slashings)):
        state.slashings[s] = rng.randrange(0, 64_000_000_000)
    state.slot = 4 * JE.SLOTS_PER_EPOCH - 1
    state.finalized_checkpoint = state.finalized_checkpoint.copy()
    state.finalized_checkpoint.epoch = 1
    if fork == JF.PHASE0:
        _phase0_attestations(state, rng)
    if fork >= JF.ELECTRA:
        _electra_queues(state, rng)
    return state, spec


def _electra_queues(state, rng):
    """Compounding validators with 33 to 2048 ETH, one with a score just
    under the guard (effective_balance * (score + bias) < 2^64), and the
    pending deposit, partial-withdrawal and consolidation queues."""
    t = jax_types.build_types(JE)
    n = len(state.validators)
    comp = rng.sample(range(n), n // 10)
    for i in comp:
        v = state.validators[i]
        v.withdrawal_credentials = b"\x02" + bytes(11) + i.to_bytes(20, "little")
        v.effective_balance = rng.randrange(33, 2049) * 10**9
        state.balances[i] = v.effective_balance + rng.randrange(-2 * 10**9, 2 * 10**9)
    top = max(comp, key=lambda i: state.validators[i].effective_balance)
    state.inactivity_scores[top] = (1 << 64) // state.validators[top].effective_balance - 4
    state.pending_balance_deposits = [
        t.PendingBalanceDeposit(index=rng.randrange(n), amount=rng.randrange(1, 64) * 10**9) for _ in range(12)
    ]
    state.pending_partial_withdrawals = [
        t.PendingPartialWithdrawal(index=i, amount=10**9, withdrawable_epoch=3 + k) for k, i in enumerate(comp[:6])
    ]
    sources = [i for i in range(n) if state.validators[i].exit_epoch < 4 and not state.validators[i].slashed][:4]
    for i in sources[:2]:
        state.validators[i].withdrawable_epoch = 2
    state.pending_consolidations = [
        t.PendingConsolidation(source_index=s, target_index=d) for s, d in zip(sources, comp[6:])
    ]


def _phase0_attestations(state, rng):
    t = jax_types.build_types(JE)
    prev = jax_acc.get_previous_epoch(state, JE)
    atts = []
    for slot in range(prev * JE.SLOTS_PER_EPOCH, (prev + 1) * JE.SLOTS_PER_EPOCH):
        committee = jax_acc.get_beacon_committee(state, slot, 0, JE)
        data = t.AttestationData(
            slot=slot,
            index=0,
            beacon_block_root=state.block_roots[slot % JE.SLOTS_PER_HISTORICAL_ROOT],
            source=state.previous_justified_checkpoint,
            target=t.Checkpoint(epoch=prev, root=jax_acc.get_block_root(state, prev, JE)),
        )
        atts.append(
            t.PendingAttestation(
                aggregation_bits=[rng.random() < 0.8 for _ in committee],
                data=data,
                inclusion_delay=rng.randrange(1, JE.SLOTS_PER_EPOCH),
                proposer_index=rng.randrange(len(state.validators)),
            )
        )
    state.previous_epoch_attestations = atts


def _churn(pair, rng):
    """The same registry churn on the JAX state and the port state."""
    js, ps = pair
    n = len(js.validators)
    slash = rng.randrange(n)
    bal = [(rng.randrange(n), rng.randrange(40_000_000_000)) for _ in range(40)]
    for s, mutable in ((js, False), (ps, True)):
        v = s.validators.mutate(slash) if mutable else s.validators[slash]
        v.slashed = True
        v.withdrawable_epoch = 5 + JE.EPOCHS_PER_SLASHINGS_VECTOR // 2
        for i, b in bal:
            s.balances[i] = b
        s.slot = (s.slot // JE.SLOTS_PER_EPOCH + 2) * JE.SLOTS_PER_EPOCH - 1


@pytest.mark.parametrize("fork", [JF.PHASE0, JF.ALTAIR, JF.ELECTRA])
@pytest.mark.parametrize("seed", [11, 12])
def test_resident_epochs_equal_jax_reference(fork, seed, monkeypatch):
    """The port's process_epoch over resident columns equals the JAX
    package's per-validator `process_epoch_reference` and the port's own
    (on a plain-list copy), then again on a copy() after registry churn,
    while the original stays as it was. From Altair on, the sweep runs
    through the kernel's plain version (on Electra's columns too) where
    the host guard admits the state."""
    swept = []
    plain = k7.epoch_sweep_plain
    monkeypatch.setattr(k7, "epoch_sweep_plain", lambda *a: (swept.append(1), plain(*a))[1])
    rng = random.Random(seed + 100)
    js, jspec = _base_state(fork, 520, seed)
    pspec = replace(port_minimal_spec(), **_FORKS_OF[fork])

    def port_reference(state_bytes):
        ref = state_from_ssz(state_bytes, fork.value, PE)
        port_process_epoch_reference(ref, pspec, PE)
        return ref.serialize()

    ps = state_from_ssz(js.serialize(), fork.value, PE)
    _make_persistent(ps)
    registry_columns_for(ps).refresh(ps)

    own = port_reference(ps.serialize())
    process_epoch(ps, pspec, PE)
    process_epoch_reference(js, jspec, JE)
    assert ps.serialize() == js.serialize() == own
    assert ps.hash_tree_root() == type(js).hash_tree_root_of(js)

    kept, kept_root = ps, ps.hash_tree_root()
    ps, js = ps.copy(), js.copy()
    _churn((js, ps), rng)
    own = port_reference(ps.serialize())
    process_epoch(ps, pspec, PE)
    process_epoch_reference(js, jspec, JE)
    assert ps.serialize() == js.serialize() == own
    assert ps.hash_tree_root() == type(js).hash_tree_root_of(js)
    assert kept.hash_tree_root() == kept_root == type(kept).hash_tree_root_of(kept)
    # Electra's second epoch: the score set just under the guard has grown
    # past it, so the host guard sends that sweep to the numpy path
    assert len(swept) == {JF.PHASE0: 0, JF.ALTAIR: 2, JF.ELECTRA: 1}[fork]
