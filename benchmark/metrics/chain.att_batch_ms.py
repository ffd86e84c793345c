"""Mean of the chain's ``attestation_batch`` span in the window, in ms:
``BeaconChain.process_attestation_batch`` from its gossip checks to the
fork-choice and op-pool writes."""


def read(run):
    batches = run.counters.get("span.attestation_batch.count")
    if not batches:
        return None
    return run.counters["span.attestation_batch.sum"] / batches * 1e3
