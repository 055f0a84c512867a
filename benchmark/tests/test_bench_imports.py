"""What the harness loads: no JAX and no JAX package anywhere in a run,
and nothing of the port in the reference.  Top-level module names are
compared whole (``unibev_tpu_torch`` is not ``unibev_tpu``)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmark import run

HARNESS = """
import glob, json, os, sys
import benchmark.run, benchmark.calibrate, benchmark.check, benchmark.spans
import benchmark.trace, benchmark.traffic, benchmark.weights, benchmark.shapes
import benchmark.readers, benchmark.peaks, benchmark.spec
from benchmark.run import load_file
for kind in ("metrics", "work"):
    for f in glob.glob(os.path.join(benchmark.run.HERE, kind, "*.py")):
        load_file(kind, os.path.basename(f)[:-3])
import unibev_tpu_torch.flagship, unibev_tpu_torch.parallel.train_state
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""

REFERENCE = """
import glob, importlib, json, os, sys
import benchmark.reference as ref
root = os.path.dirname(ref.__file__)
for f in sorted(glob.glob(os.path.join(root, "**", "*.py"), recursive=True)):
    rel = os.path.relpath(f, os.path.dirname(os.path.dirname(root)))
    importlib.import_module(rel[:-3].replace(os.sep, ".").replace(".__init__", ""))
import benchmark.weights
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def _top_level(code):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_port_load_no_jax():
    mods = _top_level(HARNESS)
    assert "unibev_tpu_torch" in mods and "benchmark" in mods
    assert not mods & set(run.FORBIDDEN), mods & set(run.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    mods = _top_level(REFERENCE)
    assert "benchmark" in mods
    assert not mods & ({"unibev_tpu_torch"} | set(run.FORBIDDEN))


def test_forbidden_names_are_whole():
    """The port's package name begins with the JAX package's, and is not
    it."""
    import unibev_tpu_torch  # noqa: F401
    assert "unibev_tpu" not in run.forbidden_modules()
    sys.modules["unibev_tpu"] = sys.modules["unibev_tpu_torch"]
    try:
        assert "unibev_tpu" in run.forbidden_modules()
    finally:
        del sys.modules["unibev_tpu"]
