"""The benchmark of ``unibev_tpu_torch`` on NVIDIA H100 cards.

One command runs one cell (a workload of ``BENCHMARK.json``) once::

    python3 -m benchmark.run --workload lc_eval --seed 7 --seconds 30 --trace 0

Everything a cell needs is found by name: the configuration in
``configs/<name>.json``, the traffic mix in ``traffic/<name>.json``, the
limits of its correctness check in ``limits/<workload>.json``, each
per-layer metric's reader in ``metrics/<metric>.py`` and each op's work
formula in ``work/<op>.py``.  ``reference/`` is the plain PyTorch model the
check compares against; it imports nothing of the port.  Nothing here
imports JAX or the JAX package.
"""
