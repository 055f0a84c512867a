"""PyTorch port of unibev_tpu for NVIDIA Hopper GPUs (inference slice).

Mirrors the JAX package's layout module for module; the JAX package stays
the reference it is tested against.  Importing this package imports torch
only: no JAX, no flax and no ``unibev_tpu``.
"""
