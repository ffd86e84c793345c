"""Rows sent to K1 per step (``ops.sha256.COUNTS["rows"]``): the share of
the hashing that reached the card."""


def read(run):
    steps = run.work.get("steps")
    rows = run.counters.get("sha256.rows")
    if not steps or rows is None:
        return None
    return rows / steps
