"""The window's model FLOPs (work.py) per second over the configuration's peak."""

from portbench.harness.readers import mfu


def read(ctx):
    return mfu(ctx)
