"""The port's rewards, fork revert, slot timer, task executor and
compare_fields (beacon_chain/{rewards,fork_revert,timer}.py,
utils/{task_executor,compare_fields}.py) against the JAX package on the
same seeded inputs.

Minimal preset with Altair from genesis, 64 interop validators, the CPU
device, `fake_crypto` on both sides: both harnesses extend 26 slots
alike. Rewards: every block's `compute_block_rewards` and
`compute_sync_committee_rewards` on its parent state, and
`compute_attestation_rewards` for epochs 0 and 1 on the canonical state
at the end of the following epoch (as the API's route builds it). Fork
revert: the wiped count, the blacklisted roots and the head that follows,
and the refusal of a finalized root. Tolerance: exact equality of dicts,
roots and messages.
"""

import threading
from dataclasses import replace
from types import SimpleNamespace

import pytest

from lighthouse_tpu import state_processing as jax_sp
from lighthouse_tpu.beacon_chain import fork_revert as jax_fork_revert
from lighthouse_tpu.beacon_chain import harness as jax_harness
from lighthouse_tpu.beacon_chain import rewards as jax_rewards
from lighthouse_tpu.beacon_chain import timer as jax_timer
from lighthouse_tpu.crypto import bls as jax_bls
from lighthouse_tpu.types import MinimalEthSpec as JaxE
from lighthouse_tpu.types import minimal_spec as jax_minimal_spec
from lighthouse_tpu.utils import compare_fields as jax_compare_fields
from lighthouse_tpu.utils import slot_clock as jax_slot_clock
from lighthouse_tpu.utils import task_executor as jax_task_executor
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch import state_processing as port_sp
from lighthouse_tpu_torch.beacon_chain import fork_revert as port_fork_revert
from lighthouse_tpu_torch.beacon_chain import harness as port_harness
from lighthouse_tpu_torch.beacon_chain import rewards as port_rewards
from lighthouse_tpu_torch.beacon_chain import timer as port_timer
from lighthouse_tpu_torch.crypto import bls as port_bls
from lighthouse_tpu_torch.types import MinimalEthSpec as PortE
from lighthouse_tpu_torch.types import minimal_spec as port_minimal_spec
from lighthouse_tpu_torch.utils import compare_fields as port_compare_fields
from lighthouse_tpu_torch.utils import slot_clock as port_slot_clock
from lighthouse_tpu_torch.utils import task_executor as port_task_executor

N_VALIDATORS = 64
SLOTS = 26

JAX = SimpleNamespace(
    name="jax", harness=jax_harness, bls=jax_bls, sp=jax_sp, rewards=jax_rewards,
    fork_revert=jax_fork_revert, timer=jax_timer, slot_clock=jax_slot_clock,
    task_executor=jax_task_executor, compare_fields=jax_compare_fields,
    E=JaxE, spec=jax_minimal_spec,
)
PORT = SimpleNamespace(
    name="port", harness=port_harness, bls=port_bls, sp=port_sp, rewards=port_rewards,
    fork_revert=port_fork_revert, timer=port_timer, slot_clock=port_slot_clock,
    task_executor=port_task_executor, compare_fields=port_compare_fields,
    E=PortE, spec=port_minimal_spec,
)
SIDES = (JAX, PORT)


def _harness(side, slots=0, altair=True, attest=True):
    spec = replace(side.spec(), altair_fork_epoch=0) if altair else side.spec()
    h = side.harness.BeaconChainHarness(spec, side.E, validator_count=N_VALIDATORS)
    if slots:
        h.extend_chain(slots, attest=attest)
    return h


@pytest.fixture(autouse=True)
def fake_crypto():
    prev = default_device(), jax_bls.backend_name(), port_bls.backend_setting()
    set_default_device("cpu")
    jax_bls.set_backend("fake_crypto")
    port_bls.set_backend("fake_crypto")
    yield
    set_default_device(prev[0])
    jax_bls.set_backend(prev[1])
    port_bls.set_backend(prev[2])


@pytest.fixture(scope="module")
def chains():
    prev = default_device(), jax_bls.backend_name(), port_bls.backend_setting()
    set_default_device("cpu")
    jax_bls.set_backend("fake_crypto")
    port_bls.set_backend("fake_crypto")
    try:
        return {side.name: _harness(side, SLOTS) for side in SIDES}
    finally:
        set_default_device(prev[0])
        jax_bls.set_backend(prev[1])
        port_bls.set_backend(prev[2])


def _block_at(h, slot):
    chain = h.chain
    for root, signed in chain._blocks_by_root.items():
        if int(signed.message.slot) == slot:
            return root, signed
    raise AssertionError(f"no block at slot {slot}")


def _block_rewards(side, h, slot, fn):
    chain = h.chain
    _, signed = _block_at(h, slot)
    parent = chain.state_for_block_root(bytes(signed.message.parent_root))
    return getattr(side.rewards, fn)(signed, parent, chain.spec, chain.E, chain.types)


def test_harnesses_agree(chains):
    roots = {name: bytes(h.chain.head_root) for name, h in chains.items()}
    assert roots["port"] == roots["jax"]
    assert int(chains["port"].chain.head_state.slot) == SLOTS


@pytest.mark.parametrize("slot", range(1, SLOTS + 1))
def test_block_rewards_equal(chains, slot):
    jax_out = _block_rewards(JAX, chains["jax"], slot, "compute_block_rewards")
    port_out = _block_rewards(PORT, chains["port"], slot, "compute_block_rewards")
    assert port_out == jax_out
    assert int(port_out["total"]) > 0


@pytest.mark.parametrize("slot", range(1, SLOTS + 1))
def test_sync_committee_rewards_equal(chains, slot):
    jax_out = _block_rewards(JAX, chains["jax"], slot, "compute_sync_committee_rewards")
    port_out = _block_rewards(PORT, chains["port"], slot, "compute_sync_committee_rewards")
    assert port_out == jax_out
    assert port_out


def _attestation_rewards(side, h, epoch):
    chain = h.chain
    target = (epoch + 2) * chain.E.SLOTS_PER_EPOCH - 1
    anc = chain.fork_choice.proto.proto_array.ancestor_at_slot(chain.head_root, target)
    st = chain.state_for_block_root(anc).copy()
    while st.slot < target:
        side.sp.per_slot_processing(st, chain.spec, chain.E)
    return side.rewards.compute_attestation_rewards(st, chain.spec, chain.E, chain.types.fork_of_state(st))


@pytest.mark.parametrize("epoch", [0, 1])
def test_attestation_rewards_equal(chains, epoch):
    jax_out = _attestation_rewards(JAX, chains["jax"], epoch)
    port_out = _attestation_rewards(PORT, chains["port"], epoch)
    assert port_out == jax_out
    assert len(port_out["total_rewards"]) == N_VALIDATORS


def _revert(side):
    h = _harness(side, 6, altair=False, attest=False)
    chain = h.chain
    head = bytes(chain.head_root)
    root4, _ = _block_at(h, 4)
    wiped = side.fork_revert.revert_to_fork_boundary(chain, root4)
    out = (
        wiped,
        head,
        bytes(chain.head_root),
        int(chain.head_state.slot),
        sorted(bytes(r) for r in chain.invalid_block_roots),
        chain.store.get_block(root4) is None,
    )
    h.slot_clock.set_slot(7)
    h.add_block_at_slot(7)
    return out + (bytes(chain.head_root), int(chain.head_state.slot))


def test_fork_revert_wipes_the_same_roots():
    jax_out, port_out = _revert(JAX), _revert(PORT)
    assert port_out == jax_out
    assert port_out[0] == 3 and port_out[3] == 3 and port_out[-1] == 7


def _revert_finalized(side):
    h = _harness(side, 4 * side.E.SLOTS_PER_EPOCH, altair=False)
    fin = h.chain.finalized_checkpoint
    try:
        side.fork_revert.revert_to_fork_boundary(h.chain, bytes(fin.root))
    except RuntimeError as e:
        return int(fin.epoch), bytes(fin.root), str(e), bytes(h.chain.head_root)
    return None


def test_fork_revert_refuses_a_finalized_root():
    jax_out, port_out = _revert_finalized(JAX), _revert_finalized(PORT)
    assert port_out == jax_out
    assert port_out is not None and port_out[0] >= 1 and "weak subjectivity" in port_out[2]


def _timer_ticks(side):
    clock = side.slot_clock.ManualSlotClock(genesis_time=0, seconds_per_slot=6)
    fired = []
    timer = side.timer.SlotTimer(clock, fired.append)
    verdicts = []
    for slot in (0, 0, 1, 1, 1, 5, 4, 4, 9):
        clock.set_slot(slot)
        verdicts.append(timer.tick())
    return verdicts, fired


def test_slot_timer_fires_alike():
    jax_out, port_out = _timer_ticks(JAX), _timer_ticks(PORT)
    assert port_out == jax_out
    assert port_out[1] == [0, 1, 5, 4, 9]


def _executor_run(side):
    ex = side.task_executor.TaskExecutor()
    done = threading.Event()

    def fails():
        raise ValueError("boom")

    ex.spawn(fails, "optional")
    ex.spawn(done.set, "setter")
    ex.join_all()
    before = (ex.shutdown_signal.is_triggered(), ex.shutdown_signal.reason, done.is_set())
    ex.spawn(fails, "vital", critical=True)
    ex.join_all()
    after = (ex.shutdown_signal.is_triggered(), ex.shutdown_signal.reason, ex.shutdown_signal.wait(0))
    return before, after


def test_task_executor_signals_alike():
    jax_out, port_out = _executor_run(JAX), _executor_run(PORT)
    assert port_out == jax_out
    assert port_out == ((False, None, True), (True, "critical task vital failed: boom", True))


def _diffs(side):
    h = _harness(side, altair=False)
    a = h.chain.head_state
    b = a.copy()
    same = side.compare_fields.compare_fields(a, b)
    b.slot = 99
    b.balances[3] = 123
    b.validators.mutate(1).slashed = True
    capped = side.compare_fields.compare_fields(a, b, max_diffs=2)
    return same, [repr(d) for d in side.compare_fields.compare_fields(a, b)], [repr(d) for d in capped]


def test_compare_fields_reports_alike():
    jax_out, port_out = _diffs(JAX), _diffs(PORT)
    assert port_out == jax_out
    assert port_out[0] == [] and len(port_out[1]) == 3 and len(port_out[2]) == 2
