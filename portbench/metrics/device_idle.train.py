"""The card's idle share over a profiled stretch of the window (harness/readers.py)."""

from portbench.harness.readers import idle


def read(ctx):
    return idle(ctx)
