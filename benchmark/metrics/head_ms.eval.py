"""Device ms a sample of fusion, decoder and head (the BEV encoders left out)."""

from benchmark import readers


def read(ctx):
    return readers.layer_ms(ctx, "head")
