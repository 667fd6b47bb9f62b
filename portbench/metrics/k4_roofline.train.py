"""K4's share of its roofline over the training window's launches (harness/readers.py)."""

from portbench.harness.readers import roofline


def read(ctx):
    return roofline(ctx, "k4")
