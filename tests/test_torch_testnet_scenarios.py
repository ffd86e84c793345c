"""The port's fleet scenarios held to the JAX package's: the smoke
partition-heal and the equivocating proposer, each run once a package in a
module-scoped fixture (fake_crypto, the runners' own seeds), plus the
`slow` full-fleet regimes (the eclipse, the column withholding and the late
proposer have files of their own, so that no file takes much more than a
minute and a half on the CPU).

Each scenario's first test holds the port's report to the JAX test's own
bounds (tests/test_testnet_scenarios.py). Its second compares the two
packages' runs on what two runs of the JAX scenario with one seed gave
alike (`test_torch_testnet.run_fleet` collects it): one interop genesis
root, the fault verbs with their seeded draws and results, the fault
injections by kind and the oracle's passes and failures, and of the
report:
  * smoke: recovery_slots (12);
  * equivocation: equivocation_slot, proposer, slashings_emitted,
    slasher_cycles;
and, for equivocation, every node's finalized and justified epochs at
the end (2 and 3 in every run). The smoke scenario's
end epochs are not compared: four runs on an idle CPU all ended at
finalized 1, justified 3, but under a loaded one the port's ended at
finalized 2 while the JAX package's stayed at 1 (convergence is declared
at the first slot with one head and finality past the heal, and which
epochs were justified by then depends on which of the partition's
attestations made it into blocks). Seconds are never compared, nor block
roots, which differ between runs of either package. The slow regimes compare the genesis, the fault verbs
and the counters, which their scripts fix."""

import pytest

from test_torch_testnet import S, assert_same_run, run_both


@pytest.fixture(scope="module")
def smoke():
    return run_both("run_smoke_scenario")


@pytest.fixture(scope="module")
def equivocation():
    return run_both("run_equivocation_scenario")


def test_scenario_smoke_partition_heal_converges(smoke):
    report = smoke["port"]["report"]
    assert report["recovery_slots"] <= 6 * S
    assert report["recovery_to_finality_s"] > 0


def test_scenario_smoke_as_in_the_jax_package(smoke):
    assert_same_run(smoke, ("seed", "recovery_slots"), epochs=False)
    (partition,) = [v for v in smoke["port"]["fault_verbs"] if v[0] == "partition"]
    lone, rest = partition[1]
    assert len(lone) == 1 and sorted(lone + rest) == ["node0", "node1", "node2"]


def test_equivocating_proposer_slashed_exactly_once(equivocation):
    report = equivocation["port"]["report"]
    assert report["slashings_emitted"] == 1
    assert report["slasher_cycles"] >= 1


def test_equivocation_as_in_the_jax_package(equivocation):
    assert_same_run(equivocation, ("seed", "equivocation_slot", "proposer", "slashings_emitted", "slasher_cycles"))


# -- full-fleet scenarios (slow) ---------------------------------------------------


def _same_script(runs: dict) -> dict:
    jax, port = runs["jax"], runs["port"]
    assert len(port["genesis_state_roots"]) == 1
    assert port["genesis_state_roots"] == jax["genesis_state_roots"]
    assert port["fault_verbs"] == jax["fault_verbs"] and port["counters"] == jax["counters"]
    return port["report"]


@pytest.mark.slow
def test_partition_heal_six_node_fleet():
    report = _same_script(run_both("run_partition_heal_scenario"))
    assert report["max_reorg_depth"] >= 1
    assert report["recovery_slots"] <= 6 * S


@pytest.mark.slow
def test_partition_heal_ten_node_fleet():
    report = _same_script(run_both("run_partition_heal_scenario", node_count=10, validator_count=50, seed=11))
    assert report["max_reorg_depth"] >= 1
    assert report["recovery_to_finality_s"] > 0


@pytest.mark.slow
def test_late_delivery_regime():
    report = _same_script(run_both("run_late_delivery_scenario"))
    assert report["recovery_slots"] <= 6 * S


@pytest.mark.slow
def test_gossip_flood_sheds_and_finalizes():
    report = _same_script(run_both("run_gossip_flood_scenario"))
    assert report["flood_sent"] > 0
    assert any(v > 0 for v in report["shed"].values())
    assert min(report["finalized"]) >= 1


@pytest.mark.slow
def test_churn_soak_fleet_keeps_finalizing_with_bounded_stores():
    report = _same_script(run_both("run_churn_soak_scenario", churn_rounds=2))
    assert report["churn_rounds"] == 2
    assert report["finalized_epoch_min"] >= 3
    assert report["finalized_slots_per_wall_s"] > 0
    assert report["hot_store_growth"] <= 4.0


@pytest.mark.slow
def test_block_production_bounded_under_flood():
    report = _same_script(run_both("run_production_under_flood_scenario"))
    assert report["flood_sent"] > 0
    assert report["blocks_published"] > 0
    assert report["mean_production_ms"] <= 1000.0
    assert min(report["finalized"]) >= 1
