"""The port's column-withholding scenario held to the JAX package's: on
Deneb from genesis with DasTestnetEthSpec (64-element blobs, 16 columns)
and the KZG engine on the 64-point dev setup (the port's on its plain
versions here), an adversary withholding 75% of a blob block's columns is
refused by every honest node while the chain finalizes past it, and one
withholding 37.5% has its block reconstructed and imported fleet-wide.
One run a package in a module-scoped fixture (fake_crypto, seed 6).

The first test holds the port's report to the JAX test's bounds; the
second compares the two packages' runs on what two runs of the JAX
scenario gave alike: one interop genesis root, the fault verbs with the
seeded withheld column sets, the fault and oracle counters, every node's
finalized and justified epochs at the end, and of the report adversary,
withheld_refusal, refusal_recovery_slots and recovery_slots. Not
compared: sampling_failures, the slot-edge sampling retries that fail (3
to 6 over runs of either package), and reconstructions (4 in every run on
an idle CPU, but 3 in a JAX run beside five other test workers: which
nodes rebuild the matrix depends on how many columns gossip brought each
before its slot-edge check)."""

import pytest

import lighthouse_tpu_torch.metrics as p_metrics
from test_torch_testnet import S, assert_same_run, run_both


@pytest.fixture(scope="module")
def withholding():
    before = p_metrics.REGISTRY.counter("das_reconstructions_total").value()
    runs = run_both("run_column_withholding_scenario", das=True)
    runs["port"]["reconstructions_counted"] = p_metrics.REGISTRY.counter("das_reconstructions_total").value() - before
    return runs


def test_column_withholding_refusal_then_recovery(withholding):
    port = withholding["port"]
    report = port["report"]
    assert report["sampling_failures"] >= 1
    assert report["reconstructions"] >= 1
    assert len(report["withheld_refusal"]) == 12  # 0.75 * 16 columns
    assert report["recovery_slots"] <= 6 * S
    assert port["counters"]["fault:withhold"] >= 2
    assert port["reconstructions_counted"] >= 1


def test_column_withholding_as_in_the_jax_package(withholding):
    assert_same_run(
        withholding,
        ("seed", "adversary", "withheld_refusal", "refusal_recovery_slots", "recovery_slots"),
    )
    withheld = [v for v in withholding["port"]["fault_verbs"] if v[0] == "withhold_columns"]
    assert [len(v[3]) for v in withheld] == [12, 6]
