"""The MSDA forward's share of its roofline at the temporal self-attention, %."""

from benchmark import readers


def read(ctx):
    return readers.roofline(ctx, "msda_tsa")
