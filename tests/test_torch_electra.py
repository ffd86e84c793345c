"""Electra state processing, genesis and the block operations of
lighthouse_tpu_torch against lighthouse_tpu, on the CPU device: the JAX
package's Electra scenarios step by step through both packages from the
same genesis, a JAX harness chain crossing into Electra imported block by
block, the port's own interop genesis for every fork, and one
minimal-preset Electra block across an epoch boundary that carries every
operation of chip_smoke.py's phase 9 (attestations, sync aggregate,
withdrawals led by matured partial withdrawals, blob commitments, proposer
and attester slashings, voluntary exits, BLS-to-execution changes, bridge
deposits, deposit receipts, withdrawal requests), really signed and
verified on the host BLS backend of each package. Tolerance: exact
equality of bytes, roots and verdicts."""

from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as cs
import lighthouse_tpu.types as jax_types
import lighthouse_tpu_torch.types as port_types
from lighthouse_tpu.beacon_chain.chain import _make_persistent as jax_make_persistent
from lighthouse_tpu.beacon_chain.harness import BeaconChainHarness
from lighthouse_tpu.crypto import bls as jax_bls
from lighthouse_tpu.state_processing import electra as jax_electra
from lighthouse_tpu.state_processing import genesis as jax_genesis
from lighthouse_tpu.state_processing import per_block_processing as jax_per_block
from lighthouse_tpu.state_processing import per_slot_processing as jax_per_slot
from lighthouse_tpu.state_processing.per_block import BlockProcessingError as JaxBlockError
from lighthouse_tpu.state_processing.per_block import BlockSignatureStrategy as JaxStrategy
from lighthouse_tpu.types.chain_spec import minimal_spec as jax_minimal_spec
from lighthouse_tpu.types.eth_spec import MinimalEthSpec as JE
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.beacon_chain.chain import _make_persistent
from lighthouse_tpu_torch.crypto import bls as port_bls
from lighthouse_tpu_torch.state_processing import (
    BlockProcessingError,
    BlockSignatureStrategy,
    interop_genesis_state,
    is_valid_genesis_state,
    per_block_processing,
    per_slot_processing,
)
from lighthouse_tpu_torch.state_processing import electra as port_electra
from lighthouse_tpu_torch.state_processing import genesis as port_genesis
from lighthouse_tpu_torch.state_processing import signature_sets as port_ss
from lighthouse_tpu_torch.state_processing.registry_columns import registry_columns_for
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as port_minimal_spec
from lighthouse_tpu_torch.types.containers import build_types
from lighthouse_tpu_torch.types.convert import state_from_ssz

PE = port_types.preset_from_name("minimal")
FORK_ORDER = ("altair", "bellatrix", "capella", "deneb", "electra")
ALL_FORKS = {f"{f}_fork_epoch": 0 for f in FORK_ORDER}
FAR = 2**64 - 1
GENESIS_TIME = 1_600_000_000
ETH1_HASH = b"\x42" * 32

JAX = SimpleNamespace(
    bls=jax_bls, EL=jax_electra, genesis=jax_genesis, per_slot=jax_per_slot,
    T=jax_types.build_types(JE), E=JE, minimal_spec=jax_minimal_spec,
)
PORT = SimpleNamespace(
    bls=port_bls, EL=port_electra, genesis=port_genesis, per_slot=per_slot_processing,
    T=build_types(PE), E=PE, minimal_spec=port_minimal_spec,
)


@pytest.fixture(autouse=True)
def cpu_device_and_backends():
    prev = default_device(), jax_bls.backend_name(), port_bls.backend_setting()
    set_default_device("cpu")
    jax_bls.set_backend("fake_crypto")
    port_bls.set_backend("fake_crypto")
    yield
    set_default_device(prev[0])
    jax_bls.set_backend(prev[1])
    port_bls.set_backend(prev[2])


def _forks_until(fork: str, **extra) -> dict:
    """Fork epochs: every fork up to `fork` at genesis, the rest unset."""
    kw = {f"{f}_fork_epoch": 0 for f in FORK_ORDER[: FORK_ORDER.index(fork) + 1]} if fork != "phase0" else {}
    return {**kw, **extra}


def _jax_genesis(n: int, **forks):
    spec = replace(jax_minimal_spec(), **forks)
    return jax_genesis.interop_genesis_state(jax_bls.interop_keypairs(n), GENESIS_TIME, ETH1_HASH, spec, JE)


def _carried(js):
    """The JAX state's bytes as the port's state of the same fork."""
    return state_from_ssz(js.serialize(), JAX.T.fork_of_state(js).value, PE)


# ---------------------------------------------------------------------------
# The JAX package's Electra scenarios (tests/test_electra.py), step by step
# in both packages: each scenario yields what it checks, and the two runs
# must yield equal states (bytes) and equal values
# ---------------------------------------------------------------------------


def _genesis_at_electra_starts_in_electra(pk, st, spec):
    assert type(st).__name__ == "BeaconStateElectra"
    assert st.deposit_receipts_start_index == FAR
    assert st.earliest_exit_epoch >= 1
    assert list(st.pending_balance_deposits) == []
    assert st.fork.current_version == spec.electra_fork_version
    yield st


def _upgrade_from_deneb_queues_compounding_excess(pk, st, spec):
    assert type(st).__name__ == "BeaconStateDeneb"
    st.validators[0].withdrawal_credentials = b"\x02" + b"\x00" * 11 + b"\xaa" * 20
    st.balances[0] = 40_000_000_000
    while st.slot < pk.E.SLOTS_PER_EPOCH:
        pk.per_slot(st, spec, pk.E)
        yield st
    assert type(st).__name__ == "BeaconStateElectra"
    assert st.balances[0] == spec.min_activation_balance
    assert any(d.index == 0 and d.amount == 8_000_000_000 for d in st.pending_balance_deposits)


def _electra_state_ssz_roundtrip(pk, st, spec):
    st.pending_balance_deposits.append(pk.T.PendingBalanceDeposit(index=1, amount=5))
    st.pending_partial_withdrawals.append(pk.T.PendingPartialWithdrawal(index=2, amount=7, withdrawable_epoch=9))
    st.pending_consolidations.append(pk.T.PendingConsolidation(source_index=1, target_index=2))
    back = type(st).deserialize(st.serialize())
    assert back.hash_tree_root() == st.hash_tree_root()
    assert back.pending_partial_withdrawals[0].withdrawable_epoch == 9
    yield st
    yield back.hash_tree_root()


def _deposit_receipt_flows_through_pending_queue(pk, st, spec):
    n0 = len(st.validators)
    kp = pk.bls.interop_keypairs(n0 + 1)[-1]
    data = pk.genesis.build_deposit_data(kp, 32_000_000_000, spec, pk.E)
    receipt = pk.T.DepositReceipt(
        pubkey=data.pubkey, withdrawal_credentials=data.withdrawal_credentials,
        amount=data.amount, signature=data.signature, index=77,
    )
    pk.EL.process_deposit_receipt(st, receipt, spec, pk.E)
    assert st.deposit_receipts_start_index == 77 and len(st.validators) == n0 + 1
    assert st.validators[-1].effective_balance == 0 and st.balances[-1] == 0
    assert st.pending_balance_deposits[-1].amount == 32_000_000_000
    yield st
    pk.EL.process_pending_balance_deposits(st, spec, pk.E)
    assert st.balances[-1] == 32_000_000_000 and list(st.pending_balance_deposits) == []
    yield st


def _el_withdrawal_request_full_exit(pk, st, spec):
    addr = b"\xaa" * 20
    v = st.validators[3]
    v.withdrawal_credentials = b"\x01" + b"\x00" * 11 + addr
    st.slot = (spec.shard_committee_period + 2) * pk.E.SLOTS_PER_EPOCH
    req = pk.T.ExecutionLayerWithdrawalRequest(
        source_address=addr, validator_pubkey=v.pubkey, amount=spec.full_exit_request_amount
    )
    pk.EL.process_execution_layer_withdrawal_request(st, req, spec, pk.E)
    assert st.validators[3].exit_epoch != FAR
    yield st
    v5 = st.validators[5]
    v5.withdrawal_credentials = b"\x01" + b"\x00" * 11 + addr
    bad = pk.T.ExecutionLayerWithdrawalRequest(
        source_address=b"\xbb" * 20, validator_pubkey=v5.pubkey, amount=spec.full_exit_request_amount
    )
    pk.EL.process_execution_layer_withdrawal_request(st, bad, spec, pk.E)
    assert st.validators[5].exit_epoch == FAR
    yield st


def _el_withdrawal_request_partial_compounding(pk, st, spec):
    addr = b"\xcc" * 20
    v = st.validators[2]
    v.withdrawal_credentials = b"\x02" + b"\x00" * 11 + addr
    v.effective_balance = spec.min_activation_balance
    st.balances[2] = spec.min_activation_balance + 3_000_000_000
    st.slot = (spec.shard_committee_period + 2) * pk.E.SLOTS_PER_EPOCH
    req = pk.T.ExecutionLayerWithdrawalRequest(source_address=addr, validator_pubkey=v.pubkey, amount=2_000_000_000)
    pk.EL.process_execution_layer_withdrawal_request(st, req, spec, pk.E)
    assert len(st.pending_partial_withdrawals) == 1 and st.validators[2].exit_epoch == FAR
    w = st.pending_partial_withdrawals[0]
    assert w.index == 2 and w.amount == 2_000_000_000
    yield st
    matured = st.copy()
    matured.slot = (w.withdrawable_epoch + 1) * pk.E.SLOTS_PER_EPOCH
    withdrawals, partials = pk.EL.get_expected_withdrawals_electra(matured, spec, pk.E)
    assert partials == 1 and withdrawals[0].validator_index == 2 and withdrawals[0].amount == 2_000_000_000
    yield [pk.T.Withdrawal.serialize_value(x) for x in withdrawals]


def _multiple_pending_partials_cap_against_remaining_excess(pk, st, spec):
    v = st.validators[4]
    v.withdrawal_credentials = b"\x02" + b"\x00" * 11 + b"\xdd" * 20
    v.effective_balance = spec.min_activation_balance
    excess = 5_000_000_000
    st.balances[4] = spec.min_activation_balance + excess
    for _ in range(3):
        st.pending_partial_withdrawals.append(
            pk.T.PendingPartialWithdrawal(index=4, amount=3_000_000_000, withdrawable_epoch=0)
        )
    st.slot = 2 * pk.E.SLOTS_PER_EPOCH
    yield st
    withdrawals, partials = pk.EL.get_expected_withdrawals_electra(st, spec, pk.E)
    mine = [w.amount for w in withdrawals if w.validator_index == 4]
    assert partials == 3 and mine == [3_000_000_000, 2_000_000_000]
    yield [pk.T.Withdrawal.serialize_value(x) for x in withdrawals]


def _pending_consolidations_transfer_balance(pk, st, spec):
    st.pending_consolidations.append(pk.T.PendingConsolidation(source_index=1, target_index=2))
    st.validators[1].withdrawable_epoch = 0
    b1, b2 = st.balances[1], st.balances[2]
    pk.EL.process_pending_consolidations(st, spec, pk.E)
    moved = min(b1, spec.min_activation_balance)
    assert (st.balances[1], st.balances[2]) == (b1 - moved, b2 + moved)
    assert list(st.pending_consolidations) == []
    yield st


def _effective_balance_updates_compounding_cap(pk, st, spec):
    st.validators[0].withdrawal_credentials = b"\x02" + b"\x00" * 31
    st.balances[0] = 100_000_000_000
    pk.EL.process_effective_balance_updates_electra(st, spec, pk.E)
    assert st.validators[0].effective_balance == 100_000_000_000
    yield st
    st.balances[1] = 100_000_000_000
    pk.EL.process_effective_balance_updates_electra(st, spec, pk.E)
    assert st.validators[1].effective_balance == spec.min_activation_balance
    yield st


SCENARIOS = {
    f.__name__.lstrip("_"): (f, extra)
    for f, extra in (
        (_genesis_at_electra_starts_in_electra, {}),
        (_upgrade_from_deneb_queues_compounding_excess, {"electra_fork_epoch": 1}),
        (_electra_state_ssz_roundtrip, {}),
        (_deposit_receipt_flows_through_pending_queue, {}),
        (_el_withdrawal_request_full_exit, {}),
        (_el_withdrawal_request_partial_compounding, {}),
        (_multiple_pending_partials_cap_against_remaining_excess, {}),
        (_pending_consolidations_transfer_balance, {}),
        (_effective_balance_updates_compounding_cap, {}),
    )
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_electra_scenario_equals_jax(name):
    """One scenario from one JAX genesis of 16 validators, carried across:
    after every step the port's state bytes equal the JAX package's, and
    every value the scenario reads (withdrawals, roots) is equal."""
    scenario, extra = SCENARIOS[name]
    forks = {**ALL_FORKS, **extra}
    jspec, pspec = replace(jax_minimal_spec(), **forks), replace(port_minimal_spec(), **forks)
    js = _jax_genesis(16, **forks)
    ps = _carried(js)
    steps = 0
    for got, want in zip(scenario(PORT, ps, pspec), scenario(JAX, js, jspec), strict=True):
        if hasattr(want, "serialize"):
            assert type(got).__name__ == type(want).__name__
            assert got.serialize() == want.serialize(), f"{name}: step {steps}"
            assert got.hash_tree_root() == want.hash_tree_root()
        else:
            assert got == want, f"{name}: step {steps}"
        steps += 1
    assert steps >= 1


def test_chain_crossing_into_electra_equals_jax():
    """The tenth scenario: the JAX harness (a mock execution layer) runs a
    minimal chain that upgrades at epochs 1 (Capella), 2 (Deneb) and 3
    (Electra) and finalizes; the port imports every block from the same
    genesis, and its state root equals the JAX package's after every slot
    and every block; the end state is Electra, byte-equal, with finality
    at epoch 4 or later."""
    forks = dict(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=1, deneb_fork_epoch=2, electra_fork_epoch=3)
    jspec, pspec = replace(jax_minimal_spec(), **forks), replace(port_minimal_spec(), **forks)
    h = BeaconChainHarness(jspec, JE, validator_count=16, mock_execution_layer=True)
    genesis = h.chain.head_state.copy()
    h.extend_chain(6 * JE.SLOTS_PER_EPOCH)
    blocks, root = [], h.chain.head_root
    while root in h.chain._blocks_by_root:
        blk = h.chain._blocks_by_root[root]
        blocks.append(blk)
        root = bytes(blk.message.parent_root)
    blocks.reverse()

    ps = _carried(genesis)
    _make_persistent(ps)
    js = genesis.copy()
    for signed in blocks:
        while ps.slot < signed.message.slot:
            per_slot_processing(ps, pspec, PE)
            jax_per_slot(js, jspec, JE)
            assert ps.hash_tree_root() == js.hash_tree_root(), f"slot {ps.slot}"
        fork = pspec.fork_name_at_epoch(int(signed.message.slot) // PE.SLOTS_PER_EPOCH)
        pblock = PORT.T.types_for_fork(fork).SignedBeaconBlock.deserialize(signed.serialize())
        per_block_processing(ps, pblock, pspec, PE, BlockSignatureStrategy.VERIFY_BULK)
        jax_per_block(js, signed, jspec, JE, JaxStrategy.VERIFY_BULK)
        assert ps.hash_tree_root() == js.hash_tree_root() == bytes(signed.message.state_root), f"block {ps.slot}"
    assert type(ps).__name__ == "BeaconStateElectra"
    assert ps.serialize() == js.serialize() == h.chain.head_state.serialize()
    assert ps.finalized_checkpoint.epoch >= 4
    assert bytes(ps.latest_execution_payload_header.block_hash) != bytes(32)


# ---------------------------------------------------------------------------
# Genesis: the port's own interop genesis
# ---------------------------------------------------------------------------

GENESIS_FORKS = ("phase0", *FORK_ORDER)


@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("fork", GENESIS_FORKS)
def test_interop_genesis_equals_jax(fork, n):
    """The port's interop_genesis_state (deposits with incremental proofs
    from its DepositTree, the upgrades to the genesis fork) byte-equal to
    the JAX package's, under each package's fake_crypto backend."""
    forks = _forks_until(fork)
    pspec = replace(port_minimal_spec(), **forks)
    ps = interop_genesis_state(port_bls.interop_keypairs(n), GENESIS_TIME, ETH1_HASH, pspec, PE)
    js = _jax_genesis(n, **forks)
    assert PORT.T.fork_of_state(ps).value == fork
    assert ps.serialize() == js.serialize()
    assert ps.hash_tree_root() == js.hash_tree_root()
    assert is_valid_genesis_state(ps, replace(pspec, min_genesis_active_validator_count=n, min_genesis_time=0), PE)
    assert not is_valid_genesis_state(ps, replace(pspec, min_genesis_active_validator_count=n + 1), PE)


def test_interop_genesis_with_real_keys_equals_jax():
    """Eight interop keys on the host backends: the deposits really signed
    and batch-verified in initialize_beacon_state_from_eth1, and the
    Electra genesis byte-equal; the deposit tree's root and every proof
    equal to the JAX package's."""
    jax_bls.set_backend("host")
    port_bls.set_backend("host")
    pspec = replace(port_minimal_spec(), **ALL_FORKS)
    ps = interop_genesis_state(port_bls.interop_keypairs(8), GENESIS_TIME, ETH1_HASH, pspec, PE)
    js = _jax_genesis(8, **ALL_FORKS)
    assert ps.serialize() == js.serialize()
    assert [bytes(v.pubkey) for v in ps.validators] == [kp.pk.to_bytes() for kp in port_bls.interop_keypairs(8)]
    pt, jt = port_genesis.DepositTree(), jax_genesis.DepositTree()
    for i in range(11):
        leaf = bytes([i]) * 32
        pt.push(leaf)
        jt.push(leaf)
        assert pt.root() == jt.root()
        assert [pt.proof(j) for j in range(i + 1)] == [jt.proof(j) for j in range(i + 1)]


# ---------------------------------------------------------------------------
# One minimal-preset Electra block with every operation of phase 9
# ---------------------------------------------------------------------------

MINIMAL_SIZES = {
    "compounding": 0.1,
    "pending_deposits": 8,
    "pending_partials": 4,
    "matured_partials": 2,
    "consolidations": 4,
    "withdrawable_consolidations": 2,
    "ejected": 2,
    "proposer_slashings": 1,
    "attester_slashings": 1,
    "attester_slashing_signers": 2,
    "exits": 4,
    "bls_changes": 4,
    "deposits": 2,
    "receipts": 4,
    "full_exit_requests": 2,
    "partial_requests": 2,
}
BLOCK_VALIDATORS = 128
BLOCK_EPOCH = 66  # past the minimal shard_committee_period (64)


def _keyed_sync_committee(committee, old_to_new: dict):
    pubkeys = [old_to_new[bytes(pk)] for pk in committee.pubkeys]
    agg = port_bls.aggregate_pubkeys([port_ss.pubkey_from_bytes(pk) for pk in pubkeys])
    return PORT.T.SyncCommittee(pubkeys=pubkeys, aggregate_pubkey=agg.to_bytes())


@pytest.fixture(scope="module")
def electra_block():
    """The pre-state (the last slot of epoch 66 of a 128-validator Electra
    genesis from the JAX package, given seeded real keys and phase 9's
    Electra pre-state by chip_smoke.electra_prestate) and a block for the
    next slot built by chip_smoke.transition_block with
    chip_smoke.ElectraOperations at minimal counts, on the port."""
    prev = jax_bls.backend_name(), port_bls.backend_setting(), default_device()
    jax_bls.set_backend("fake_crypto")
    port_bls.set_backend("host")
    set_default_device("cpu")
    try:
        js = _jax_genesis(BLOCK_VALIDATORS, **ALL_FORKS)
        js.slot = (BLOCK_EPOCH + 1) * JE.SLOTS_PER_EPOCH - 1
        pspec = replace(port_minimal_spec(), **ALL_FORKS)
        ps = _carried(js)
        _make_persistent(ps)
        rng = np.random.default_rng(15)
        sks, _, pks = cs.bls_keys(rng, BLOCK_VALIDATORS)
        old_to_new = {bytes(v.pubkey): pk for v, pk in zip(ps.validators, pks)}
        ps.validators.set_fields_bulk(list(range(BLOCK_VALIDATORS)), "pubkey", pks)
        ps.current_sync_committee = _keyed_sync_committee(ps.current_sync_committee, old_to_new)
        ps.next_sync_committee = _keyed_sync_committee(ps.next_sync_committee, old_to_new)
        registry_columns_for(ps).refresh(ps)
        prestate = cs.electra_prestate(ps, PORT.T, PE, pspec, seed=15, sizes=MINIMAL_SIZES)
        ops = cs.ElectraOperations(PORT.T, PE, pspec, 15, prestate, sizes=MINIMAL_SIZES)
        commitments = [bytes(pk) for pk in pks[:6]]
        blk = cs.transition_block(
            ps, PORT.T, PE, pspec, dict(enumerate(sks)), 15, commitments, fork="electra", operations=ops
        )
        return {"pre": ps.serialize(), "blk": blk, "prestate": prestate, "ops": ops.counts()}
    finally:
        jax_bls.set_backend(prev[0])
        port_bls.set_backend(prev[1])
        set_default_device(prev[2])


def _both(pre: bytes, block: bytes):
    """The block imported across the boundary by each package from the same
    pre-state bytes (tree-states in both)."""
    jspec, pspec = replace(jax_minimal_spec(), **ALL_FORKS), replace(port_minimal_spec(), **ALL_FORKS)
    js = JAX.T.types_for_fork("electra").BeaconState.deserialize(pre)
    jax_make_persistent(js)
    ps = state_from_ssz(pre, "electra", PE)
    _make_persistent(ps)
    jax_per_slot(js, jspec, JE)
    per_slot_processing(ps, pspec, PE)
    assert ps.serialize() == js.serialize()
    jblock = JAX.T.types_for_fork("electra").SignedBeaconBlock.deserialize(block)
    pblock = PORT.T.types_for_fork("electra").SignedBeaconBlock.deserialize(block)
    return (js, jblock, jspec), (ps, pblock, pspec)


def test_block_with_every_operation_equals_jax(electra_block):
    """The block is accepted by both packages under VERIFY_BULK on their
    host BLS backends, and the post-states are byte-equal, with the root
    the block names; every operation took effect."""
    jax_bls.set_backend("host")
    port_bls.set_backend("host")
    blk = electra_block["blk"]
    (js, jblock, jspec), (ps, pblock, pspec) = _both(electra_block["pre"], blk["signed"])
    body = pblock.message.body
    assert electra_block["ops"] == {
        "proposer_slashings": len(body.proposer_slashings),
        "attester_slashings": len(body.attester_slashings),
        "attester_slashing_signers": MINIMAL_SIZES["attester_slashing_signers"],
        "voluntary_exits": len(body.voluntary_exits),
        "bls_to_execution_changes": len(body.bls_to_execution_changes),
        "deposits": len(body.deposits),
        "deposit_receipts": len(body.execution_payload.deposit_receipts),
        "withdrawal_requests": len(body.execution_payload.withdrawal_requests),
    }
    assert all(electra_block["ops"].values())
    # one attestation per committee of the boundary's last two slots
    assert len(body.attestations) == 2 * blk["committees_per_slot"] >= 6
    assert len(body.blob_kzg_commitments) == 6
    # the matured partial withdrawals lead the payload's withdrawals
    matured = MINIMAL_SIZES["matured_partials"]
    lead = [int(w.validator_index) for w in body.execution_payload.withdrawals[:matured]]
    assert lead == [int(p.index) for p in list(ps.pending_partial_withdrawals)[:matured]]

    jax_per_block(js, jblock, jspec, JE, JaxStrategy.VERIFY_BULK)
    per_block_processing(ps, pblock, pspec, PE, BlockSignatureStrategy.VERIFY_BULK)
    assert ps.serialize() == js.serialize()
    assert ps.hash_tree_root() == js.hash_tree_root() == blk["post_root"]
    assert cs.host_state_root(ps) == blk["post_root"]
    # every operation changed the state
    n = BLOCK_VALIDATORS
    assert len(ps.validators) == n + MINIMAL_SIZES["deposits"] + MINIMAL_SIZES["receipts"]
    assert sum(bool(v.slashed) for v in ps.validators) >= 1 + MINIMAL_SIZES["attester_slashing_signers"]
    for change in body.bls_to_execution_changes:
        assert bytes(ps.validators[change.message.validator_index].withdrawal_credentials)[:1] == b"\x01"
    for signed_exit in body.voluntary_exits:
        assert ps.validators[signed_exit.message.validator_index].exit_epoch != FAR
    assert ps.deposit_receipts_start_index == js.eth1_data.deposit_count
    assert ps.eth1_deposit_index == js.eth1_data.deposit_count


@pytest.mark.parametrize("altered", ["attestation", "exit_signed_over_another_message", "bls_change_signed_over_another_message"])
def test_altered_blocks_refused_by_both(electra_block, altered):
    """The block with one attestation, one voluntary exit or one
    BLS-to-execution change signed over another message: both packages
    refuse it in their bulk signature verification."""
    jax_bls.set_backend("host")
    port_bls.set_backend("host")
    blk = electra_block["blk"]
    data = blk["tampered"] if altered == "attestation" else blk["altered"][altered]
    (js, jblock, jspec), (ps, pblock, pspec) = _both(electra_block["pre"], data)
    with pytest.raises(JaxBlockError, match="bulk signature verification failed"):
        jax_per_block(js, jblock, jspec, JE, JaxStrategy.VERIFY_BULK)
    with pytest.raises(BlockProcessingError, match="bulk signature verification failed"):
        per_block_processing(ps, pblock, pspec, PE, BlockSignatureStrategy.VERIFY_BULK)
