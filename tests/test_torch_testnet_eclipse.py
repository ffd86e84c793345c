"""The port's eclipse scenario held to the JAX package's: a victim behind
two lying attacker peers falls behind on its own fork while the honest
fleet finalizes, then recovers to the fleet head once honest peers are
readmitted. One run a package in a module-scoped fixture (fake_crypto,
seed 2).

The first test holds the port's report to the JAX test's bounds; the
second compares the two packages' runs on what four runs (two a package)
gave alike: one interop genesis root, the fault verbs with the seeded
victim, the fault and oracle counters, and of the report victim,
victim_gap_slots and recovery_slots. Not compared: the failed sync runs
during the eclipse (3 and 9 in two JAX runs) and the end epochs, which
two JAX runs gave alike but one port run on a loaded CPU did not (it
finalized an epoch less: when honest finality first moves under the
eclipse depends on how fast gossip drains)."""

import pytest

from test_torch_testnet import S, assert_same_run, run_both


@pytest.fixture(scope="module")
def eclipse():
    return run_both("run_eclipse_scenario")


def test_eclipse_victim_recovers_when_honest_peers_readmitted(eclipse):
    report = eclipse["port"]["report"]
    assert report["victim_gap_slots"] > 0
    assert report["recovery_slots"] <= 6 * S


def test_eclipse_as_in_the_jax_package(eclipse):
    assert_same_run(eclipse, ("seed", "victim", "victim_gap_slots", "recovery_slots"), epochs=False)
    (verb,) = [v for v in eclipse["port"]["fault_verbs"] if v[0] == "eclipse"]
    assert verb[1] == [eclipse["port"]["report"]["victim"], ["attacker0", "attacker1"]]
