"""Device ms a sample of the camera BEV encoder."""

from benchmark import readers


def read(ctx):
    return readers.layer_ms(ctx, "bev_encoders")
