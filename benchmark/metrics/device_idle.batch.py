"""Per cent of the traced stretch in which no operation ran on the
device (the union of the profiler's device events)."""

from harness.readings import idle_share


def read(ctx):
    return idle_share(ctx)
