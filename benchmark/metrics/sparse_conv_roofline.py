"""The sparse convolutions' (rulebooks and convs) share of their roofline, %."""

from benchmark import readers


def read(ctx):
    return readers.roofline(ctx, "sparse_conv")
