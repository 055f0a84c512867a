"""Device ms a sample of the decoder and head (the BEV encoder and alignment left out)."""

from benchmark import readers


def read(ctx):
    return readers.layer_ms(ctx, "head")
