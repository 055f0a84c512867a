"""Device ms a sample of the LiDAR branch: voxelizer, sparse encoder, SECOND, SECONDFPN."""

from benchmark import readers


def read(ctx):
    return readers.layer_ms(ctx, "lidar_branch")
