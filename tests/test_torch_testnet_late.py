"""The port's late-proposer scenario held to the JAX package's: on 4 nodes
a block withheld past the attestation deadline loses its committee (they
attest the parent, same-slot gossip votes carried by the fork-choice
deferral queue), and the next slot's proposer builds on the parent,
orphaning it while the fleet single-heads and finalizes. One run a package
in a module-scoped fixture (fake_crypto, seed 8).

The first test holds the port's report to the JAX test's bounds; the
second compares the two packages' runs on what four runs (two a package)
gave alike: one interop genesis root, the fault and oracle counters, every
node's finalized and justified epochs at the end (2 and 3), and of the
report late_slot, deferred_applied, finalized and recovery_slots."""

import pytest

from test_torch_testnet import S, assert_same_run, run_both


@pytest.fixture(scope="module")
def late_proposer():
    return run_both("run_late_proposer_scenario")


def test_late_proposer_reorged_out_while_finality_advances(late_proposer):
    report = late_proposer["port"]["report"]
    assert report["deferred_applied"] > 0
    assert min(report["finalized"]) >= 1
    assert report["recovery_slots"] <= 6 * S


def test_late_proposer_as_in_the_jax_package(late_proposer):
    assert_same_run(late_proposer, ("seed", "late_slot", "deferred_applied", "finalized", "recovery_slots"))
