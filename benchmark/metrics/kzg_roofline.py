"""The blob route's KZG kernels' share of their roofline, in %: the least
time of what K8 and K4 compute of each segment's batch
(``roofline.kzg_batch_seconds``: the barycentric evaluations and the
two-pair pairing) over the device time of K8's evaluation and K4's pairing
kernels in the traced window. The batch's host stages (Fiat-Shamir, the
RLC) are not in it."""

from benchmark.roofline import KZG_KERNELS, kzg_batch_seconds


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.device_seconds(names=KZG_KERNELS)
    segments = run.work.get("segments") or []
    if seconds <= 0 or not segments:
        return None
    return 100 * sum(kzg_batch_seconds(b, run.work["n"]) for b, _ in segments) / seconds
