"""Host ms a predict call, less its waiting CUDA calls (traced part)."""

from benchmark import readers


def read(ctx):
    return readers.host_ms(ctx)
