"""The DCNv2 forward's share of its roofline, %."""

from benchmark import readers


def read(ctx):
    return readers.roofline(ctx, "dcn_fwd")
