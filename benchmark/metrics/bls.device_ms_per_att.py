"""Device time of the BLS kernels in the traced window per attestation given
a verdict, in ms."""

from benchmark.roofline import BLS_KERNELS


def read(run):
    if run.trace is None or not run.work.get("attestations"):
        return None
    seconds = run.trace.device_seconds(names=BLS_KERNELS)
    if seconds <= 0:
        return None
    return seconds / run.work["attestations"] * 1e3
