"""Median over all calls of the window, from issue to outputs on the host."""

from benchmark import readers


def read(ctx):
    return readers.latency_ms(ctx, 50)
