"""Device ms a sample of the camera backbone and neck (ResNet, 4-level FPN)."""

from benchmark import readers


def read(ctx):
    return readers.layer_ms(ctx, "camera_backbone")
