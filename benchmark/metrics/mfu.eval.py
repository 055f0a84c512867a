"""The whole call's share of the card's bf16 peak, %."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx)
