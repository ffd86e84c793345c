"""95th percentile of the window's step times (benchmark clock), in ms: the
step sorted at rank ceil(0.95 n) of the n steps."""

import math


def read(run):
    steps = sorted(run.work.get("step_s") or [])
    if not steps:
        return None
    return steps[math.ceil(0.95 * len(steps)) - 1] * 1e3
