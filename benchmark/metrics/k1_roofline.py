"""K1's share of its roofline, in %: the least time of the SHA-256 rows
that the window's writes make dirty (``roofline.state_write_rows``, at
``SHA256_ROW_OPS`` 32-bit operations a row and 96 bytes), over K1's device
time in the traced window. None where K1 ran no launch."""

from benchmark.roofline import SHA256_ROW_OPS, least_seconds


def read(run):
    if run.trace is None:
        return None
    k1 = run.trace.device_seconds(names=("sha256_rows_kernel",))
    rows = sum(run.work.get("least_rows") or [])
    if k1 <= 0 or not rows:
        return None
    return 100 * least_seconds(int_ops=rows * SHA256_ROW_OPS, nbytes=rows * 96) / k1
