"""Host time per blob in the segment calls, in ms: the benchmark's clock
around each call, less the device time inside it, over the blobs."""


def read(run):
    if run.trace is None or not run.work.get("blobs"):
        return None
    calls = [r for r in run.trace.host_ranges if r[0] == "segment"]
    if not calls:
        return None
    host = sum((e - s) / 1e9 - run.trace.device_seconds(s, e) for _, s, e in calls)
    return host / run.work["blobs"] * 1e3
