"""The MSDA forward's share of its roofline at the camera SCA and decoder sites, %."""

from benchmark import readers


def read(ctx):
    return readers.roofline(ctx, "msda_fwd")
