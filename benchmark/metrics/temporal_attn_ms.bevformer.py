"""Device ms a sample of the encoder layers' temporal self-attention."""

from benchmark import readers


def read(ctx):
    return readers.layer_ms(ctx, "temporal_attention")
