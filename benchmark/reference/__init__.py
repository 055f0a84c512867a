"""The plain reference of the benchmark's correctness check.

A frozen copy of the model code of ``unibev_tpu_torch`` as it stood when the
benchmark was written, in which every op takes its plain PyTorch version on
every device (the kernel wrappers, launch plans and the kernel library are
left out), so that no later change to the port moves the yardstick.  The
check builds it in float32 with TF32 off and loads the weights the benchmark
made.  It imports nothing of ``unibev_tpu_torch``, ``unibev_tpu`` or JAX.
The module docstrings are the port's, kernels named in them included.
"""
