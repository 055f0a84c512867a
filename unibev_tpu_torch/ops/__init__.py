"""Ops of the port: hand-written CUDA kernels and their plain PyTorch versions."""
