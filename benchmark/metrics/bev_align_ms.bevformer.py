"""Device ms a sample of the alignment of the previous BEV map: rotation, shift, CAN bus embedding."""

from benchmark import readers


def read(ctx):
    return readers.layer_ms(ctx, "bev_align")
