"""Attestations given a verdict in the window per batch the lane handed the
chain (the count of ``attestation_batch`` spans)."""


def read(run):
    batches = run.counters.get("span.attestation_batch.count")
    if not batches:
        return None
    return run.work["attestations"] / batches
