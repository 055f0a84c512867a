"""The MSDA forward's share of its roofline, %."""

from benchmark import readers


def read(ctx):
    return readers.roofline(ctx, "msda_fwd")
