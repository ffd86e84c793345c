"""The BLS kernels' share of their roofline, in %: the least time of every
batch the chain verified in the window (``roofline.bls_batch_seconds`` of
its attestations and distinct messages) over the BLS kernels' device time."""

from benchmark.roofline import BLS_KERNELS, bls_batch_seconds


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.device_seconds(names=BLS_KERNELS)
    batches = run.work.get("batches") or []
    if seconds <= 0 or not batches:
        return None
    return 100 * sum(bls_batch_seconds(n, k) for n, k in batches) / seconds
