"""The epoch sweep (K7) of lighthouse_tpu_torch against lighthouse_tpu, on
the CPU device: the kernel's plain PyTorch version bit-exact with the JAX
`epoch_sweep`, the port's numpy sweep equal to the JAX package's, and the
seam in `process_epoch_altair` choosing the plain version or the numpy
sweep as the JAX package's guard does. Tolerance: exact equality of
integers and bytes.

The JAX `epoch_sweep` runs in a subprocess: importing its module turns on
JAX's x64 mode for the whole process."""

import os
import random
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

import lighthouse_tpu_torch.types as port_types
from chip_smoke import epoch_sweep_inputs
from lighthouse_tpu.beacon_chain.chain import _make_persistent as jax_make_persistent
from lighthouse_tpu.crypto import bls as jax_bls
from lighthouse_tpu.state_processing import altair as jax_altair
from lighthouse_tpu.state_processing import interop_genesis_state
from lighthouse_tpu.state_processing.per_epoch import process_epoch as jax_process_epoch
from lighthouse_tpu.state_processing.registry_columns import (
    registry_columns_for as jax_columns_for,
)
from lighthouse_tpu.types.chain_spec import minimal_spec as jax_minimal_spec
from lighthouse_tpu.types.eth_spec import MinimalEthSpec as JE
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.beacon_chain.chain import _make_persistent
from lighthouse_tpu_torch.ops import epoch_sweep as k7
from lighthouse_tpu_torch.state_processing import altair
from lighthouse_tpu_torch.state_processing.per_epoch import process_epoch
from lighthouse_tpu_torch.state_processing.registry_columns import registry_columns_for
from lighthouse_tpu_torch.types.chain_spec import ForkName
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as port_minimal_spec
from lighthouse_tpu_torch.types.convert import state_from_ssz

ROOT = Path(__file__).resolve().parent.parent
PE = port_types.preset_from_name("minimal")
N = 4096
CASES = [(seed, leak) for seed in (3, 4) for leak in (False, True)]
# Electra's range: effective balances up to 2048 ETH, scores just under the guard
ELECTRA_CASES = [(seed, leak) for seed in (5, 6) for leak in (False, True)]
FORKS = dict(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0, deneb_fork_epoch=0)
FAR = 2**64 - 1

_JAX_SWEEP = """
import sys
import numpy as np
from lighthouse_tpu.ops.epoch_sweep import epoch_sweep
columns = sys.argv[3].split(",")
data = np.load(sys.argv[1])
out = {}
for case in sorted({k.split("__")[0] for k in data.files}):
    new_balances, new_scores = epoch_sweep(
        *(data[case + "__" + c] for c in columns), data[case + "__scalars"]
    )
    out[case + "__balances"] = np.asarray(new_balances)
    out[case + "__scores"] = np.asarray(new_scores)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(autouse=True)
def cpu_device():
    prev = default_device()
    set_default_device("cpu")
    yield
    set_default_device(prev)


def _inputs(seed: int, leak: bool, max_eb_eth: int = 32):
    return epoch_sweep_inputs(np.random.default_rng(seed), N, leak, max_eb_eth)


@pytest.fixture(scope="module")
def jax_sweeps(tmp_path_factory):
    """The JAX `epoch_sweep` on every case, in one subprocess."""
    tmp = tmp_path_factory.mktemp("epoch_sweep")
    arrays = {}
    for (seed, leak), max_eb in [(c, 32) for c in CASES] + [(c, 2048) for c in ELECTRA_CASES]:
        cols, scalars = _inputs(seed, leak, max_eb)
        for name, arr in cols.items():
            arrays[f"s{seed}l{int(leak)}__{name}"] = arr
        arrays[f"s{seed}l{int(leak)}__scalars"] = scalars
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SWEEP, str(tmp / "in.npz"), str(tmp / "out.npz"), ",".join(k7.COLUMNS)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("seed,leak", CASES)
def test_plain_sweep_bit_exact_with_jax(jax_sweeps, seed, leak):
    cols, scalars = _inputs(seed, leak)
    # the edge rows are there: FAR_FUTURE_EPOCH epochs, products of 2^63
    # and more, balances below their penalties
    assert (cols["exit_epoch"] == np.uint64(FAR)).sum() > N // 2
    assert (cols["activation_epoch"] == np.uint64(FAR)).any()
    products = [int(e) * int(s) for e, s in zip(cols["effective_balance"], cols["scores"])]
    assert sum(p >= 1 << 63 for p in products) >= 64
    assert max(products) < 1 << 64

    new_balances, new_scores = k7.epoch_sweep_arrays(cols, scalars)
    case = f"s{seed}l{int(leak)}"
    assert new_balances.dtype == np.uint64 and new_scores.dtype == np.uint64
    assert np.array_equal(new_balances, jax_sweeps[case + "__balances"])
    assert np.array_equal(new_scores, jax_sweeps[case + "__scores"])
    assert k7.COUNTS["launches"] == 0  # the CPU device never launches
    # the sweep did something on every kind of row
    assert (new_balances < cols["balances"]).any() and (new_balances > cols["balances"]).any() != leak
    assert (new_balances == 0).any()


@pytest.mark.parametrize("seed,leak", ELECTRA_CASES)
def test_plain_sweep_bit_exact_with_jax_on_electra_rows(jax_sweeps, seed, leak):
    """Electra's columns: compounding rows at 33 to 2048 ETH, the edge rows'
    products of 2^63 and more at 2048 ETH with scores up to the host
    guard's limit (which the largest effective balance sets)."""
    cols, scalars = _inputs(seed, leak, 2048)
    eb, scores = cols["effective_balance"], cols["scores"]
    assert int(eb.max()) == 2048 * 10**9
    assert (eb > np.uint64(32 * 10**9)).sum() > N // 50
    products = [int(e) * int(s) for e, s in zip(eb, scores)]
    assert sum(p >= 1 << 63 for p in products) >= 64
    assert int(scores.max()) == (1 << 64) // int(eb.max()) - 4  # the guard's edge

    new_balances, new_scores = k7.epoch_sweep_arrays(cols, scalars)
    case = f"s{seed}l{int(leak)}"
    assert np.array_equal(new_balances, jax_sweeps[case + "__balances"])
    assert np.array_equal(new_scores, jax_sweeps[case + "__scores"])
    assert (new_balances < cols["balances"]).any() and (new_balances == 0).any()


def test_udiv_matches_u64_floor_division():
    import torch

    rng = np.random.default_rng(9)
    x = rng.integers(0, 2**64 - 1, 4096, dtype=np.uint64, endpoint=True)
    x[:4] = [0, 1, 2**63, 2**64 - 1]
    xt = torch.from_numpy(x.view(np.int64).copy())
    for d in (1, 3, 64, 10**9, 2**26, 2**62 + 7, 2**63 - 1, 2**63, 2**64 - 1):
        got = k7._udiv(xt, d).numpy().view(np.uint64)
        assert np.array_equal(got, x // np.uint64(d)), d


# ---------------------------------------------------------------------------
# Seeded Deneb states, built through the JAX package and carried across
# ---------------------------------------------------------------------------


def _jax_state(n: int, seed: int, epoch: int, finalized: int):
    """A Deneb state at the last slot of `epoch`, with a randomized
    registry (pending, exiting, slashed validators), participation, scores
    and balances."""
    jax_bls.set_backend("fake_crypto")
    rng = random.Random(seed)
    spec = replace(jax_minimal_spec(), **FORKS)
    state = interop_genesis_state(jax_bls.interop_keypairs(8), 1_600_000_000, b"\x42" * 32, spec, JE)
    v0 = state.validators[0]
    vs = []
    for i in range(n):
        v = v0.copy()
        v.withdrawal_credentials = bytes([rng.choice([0, 1])]) + i.to_bytes(31, "little")
        v.effective_balance = rng.choice([32_000_000_000, 31_000_000_000, 17_000_000_000])
        if rng.random() < 0.1:
            v.activation_epoch = FAR
            v.activation_eligibility_epoch = rng.choice([FAR, 0, 1])
        if rng.random() < 0.08:
            v.exit_epoch = rng.randrange(1, epoch + 3)
            v.withdrawable_epoch = v.exit_epoch + 256
        if rng.random() < 0.06:
            v.slashed = True
            v.withdrawable_epoch = rng.choice([epoch + JE.EPOCHS_PER_SLASHINGS_VECTOR // 2, epoch + 9, 1])
        vs.append(v)
    state.validators = vs
    state.balances = [rng.randrange(0, 40_000_000_000) for _ in range(n)]
    state.previous_epoch_participation = bytearray(rng.randrange(8) for _ in range(n))
    state.current_epoch_participation = bytearray(rng.randrange(8) for _ in range(n))
    state.inactivity_scores = [rng.randrange(6) for _ in range(n)]
    for s in range(len(state.slashings)):
        state.slashings[s] = rng.randrange(0, 64_000_000_000)
    state.slot = (epoch + 1) * JE.SLOTS_PER_EPOCH - 1
    state.finalized_checkpoint = state.finalized_checkpoint.copy()
    state.finalized_checkpoint.epoch = finalized
    return state


def _pair(n: int, seed: int, epoch: int, finalized: int):
    js = _jax_state(n, seed, epoch, finalized)
    ps = state_from_ssz(js.serialize(), "deneb", PE)
    jax_make_persistent(js)
    _make_persistent(ps)
    return js, ps


def _sweep_numpy(mod, columns_for, state, spec, E, fork):
    cols = columns_for(state)
    cols.refresh(state)
    arrays = mod.EpochArrays(state, E, columns=cols)
    mod.process_justification_and_finalization_altair(state, E, arrays)
    mod.process_inactivity_updates(state, spec, E, arrays)
    mod.process_rewards_and_penalties_altair(state, spec, E, fork, arrays)


@pytest.mark.parametrize("epoch,finalized", [(3, 1), (9, 1)])
def test_numpy_sweep_equals_jax(epoch, finalized):
    """The port's numpy sweep (the path where the guard does not admit a
    state) equals the JAX package's on the same EpochArrays, out of the
    inactivity leak and in it."""
    from lighthouse_tpu.types.chain_spec import ForkName as JF

    js, ps = _pair(600, 17 + epoch, epoch, finalized)
    _sweep_numpy(jax_altair, jax_columns_for, js, replace(jax_minimal_spec(), **FORKS), JE, JF.DENEB)
    _sweep_numpy(altair, registry_columns_for, ps, replace(port_minimal_spec(), **FORKS), PE, ForkName.DENEB)
    assert list(ps.balances) == list(js.balances)
    assert list(ps.inactivity_scores) == list(js.inactivity_scores)
    assert ps.hash_tree_root() == js.hash_tree_root()


def _watch(monkeypatch):
    """Count the sweep's plain version and the numpy sweep as they run."""
    ran = {"plain": 0, "numpy": 0, "in_leak": []}
    plain = k7.epoch_sweep_plain

    def counted_plain(*args):
        ran["plain"] += 1
        ran["in_leak"].append(int(args[-1][4]))
        return plain(*args)

    numpy_sweep = altair.process_inactivity_updates

    def counted_numpy(*args, **kw):
        ran["numpy"] += 1
        return numpy_sweep(*args, **kw)

    monkeypatch.setattr(k7, "epoch_sweep_plain", counted_plain)
    monkeypatch.setattr(altair, "process_inactivity_updates", counted_numpy)
    return ran


@pytest.mark.parametrize(
    "case,epoch,finalized,expect",
    [
        ("admitted", 3, 1, "plain"),
        ("admitted in the leak", 9, 1, "plain"),
        ("genesis epoch", 0, 0, "numpy"),
        ("guard trips", 3, 1, "numpy"),
    ],
)
def test_seam_chooses_as_the_guard_does(monkeypatch, case, epoch, finalized, expect):
    """On the CPU device an admitted state takes the kernel's plain
    version; the genesis epoch and a state whose effective_balance·score
    may pass 2^64 take the numpy sweep. Either way the whole transition
    equals the JAX package's (its numpy sweep)."""
    js, ps = _pair(400, 5 + epoch, epoch, finalized)
    if case == "guard trips":
        for s in (js, ps):
            s.inactivity_scores[7] = (1 << 64) // 32_000_000_000
    ran = _watch(monkeypatch)
    jax_process_epoch(js, replace(jax_minimal_spec(), **FORKS), JE)
    process_epoch(ps, replace(port_minimal_spec(), **FORKS), PE)
    assert ran["plain"] == (expect == "plain")
    assert ran["numpy"] == (expect == "numpy")
    if expect == "plain":
        assert ran["in_leak"] == [int(epoch - 1 - finalized > PE.MIN_EPOCHS_TO_INACTIVITY_PENALTY)]
    assert ps.serialize() == js.serialize()
    assert ps.hash_tree_root() == js.hash_tree_root()
