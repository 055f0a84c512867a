"""% of the traced part's wall in which the card ran nothing."""

from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx)
