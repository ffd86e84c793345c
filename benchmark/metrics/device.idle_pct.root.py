"""Share of the traced window in which no operation ran on the card, in %."""

from benchmark.harness import idle_pct


def read(run):
    return idle_pct(run.trace)
