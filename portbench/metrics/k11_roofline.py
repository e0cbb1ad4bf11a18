"""k11: the share of its roofline (core/roofline.py)."""

from portbench.core.roofline import share


def read(ctx):
    return share(ctx, "k11")
