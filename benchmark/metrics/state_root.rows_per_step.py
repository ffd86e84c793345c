"""SHA-256 rows the tree-hash cache hashed per step, on the host and the
card together (``ssz/cached_tree_hash`` ``rows_hashed``)."""


def read(run):
    steps = run.work.get("steps")
    rows = run.counters.get("tree_hash.rows_hashed")
    if not steps or rows is None:
        return None
    return rows / steps
