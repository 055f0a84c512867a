#!/usr/bin/env python3
"""Whether torch.profiler keeps every hand kernel of a traced run, on one
CUDA card.

    python3 -m unibev_tpu_torch.tools.trace_window

Traces ``REPEATS`` times, unprimed (as chip_smoke.py's profiles ran
before they opened with spin kernels) and primed
(``chip_smoke.py::_traced``, ``TRACE_PRIMERS`` spin kernels first and
``TRACE_TRAILERS`` after), two
runs whose first kernels are K10's (the voxelizer): L predict on the
flagship LC model and R predict on the flagship RC model (bf16, random
weights from seed 0, chip_smoke.py's batches); in a fresh process and again
after ``AGED`` profiler sessions of one small kernel each (chip_smoke.py
opens hundreds before its later profiles).  Prints, per run and way, K10's
kernels traced of those launched, the primers and trailers traced and the
recorded launches without a device record
(``chip_smoke.py::trace_losses``), the hand kernels
whose traced launches differ from ``_build.launches``
(``chip_smoke.py::profiled_counts``) and the names of the trace's first
device kernels; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from chip_smoke import (RC_MODES, TRACE_PRIMERS,  # noqa: E402
                        _rc_batch, _traced, profiled_counts, trace_losses)
from unibev_tpu_torch.flagship import build_flagship, synthetic_batch  # noqa: E402
from unibev_tpu_torch.ops import _build  # noqa: E402

REPEATS = 3
AGED = (0, 300)
WAYS = {"unprimed": 0, "primed": TRACE_PRIMERS}
K10_KERNELS = 5


def first_kernels(prof, n=4):
    """The names of the trace's first ``n`` device kernels, by start."""
    from torch.autograd import DeviceType
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA),
                    key=lambda e: e.start_ns())
    return [e.name()[:40] for e in events[:n]]


def trace(label, run):
    """Print each way's traced hand kernels of ``run`` against its
    launches."""
    from torch.autograd import DeviceType
    for way, primers in WAYS.items():
        rows = []
        for _ in range(REPEATS):
            before = dict(_build.launches)
            prof, _ = _traced(run, primers)
            launched = {k: v - before.get(k, 0)
                        for k, v in _build.launches.items()
                        if v != before.get(k, 0)}
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA]
            counts = profiled_counts(events, launched)
            k10 = sum(v[0] for k, v in counts.items()
                      if k.startswith("voxelize "))
            wrong = {k: v for k, v in counts.items() if v[0] != v[1]}
            kept = trace_losses(prof)
            rows.append(f"K10 {k10}/{K10_KERNELS * launched['voxelize']}, "
                        f"primers traced {kept['primers']} of {primers}, "
                        f"trailers {kept['trailers']}, launches without a "
                        f"device record {kept['lost']}{kept['where']}, differ "
                        f"{wrong or 'none'}, "
                        f"first {first_kernels(prof)}")
        print(f"  {label}, {way}:", flush=True)
        for r in rows:
            print(f"    {r}", flush=True)


def age(sessions):
    """``sessions`` profiler sessions of one small kernel each."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1024, device="cuda")
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]):
            x.add_(1.0)
            torch.cuda.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_window: no CUDA device", file=sys.stderr)
        return 1
    batch = synthetic_batch(np.random.RandomState(0), device="cuda")
    l_batch = {k: v for k, v in batch.items() if k != "img"}
    r_batch = {k: v for k, v in _rc_batch().items() if k not in RC_MODES["R"]}
    models = {"L predict": (build_flagship(device="cuda", dtype=torch.bfloat16,
                                           seed=0), l_batch),
              "R predict": (build_flagship(device="cuda", dtype=torch.bfloat16,
                                           seed=0, use_lidar=False,
                                           use_radar=True), r_batch)}
    for model, b in models.values():
        for _ in range(3):
            model.predict(b)
    torch.cuda.synchronize()
    done = 0
    for sessions in AGED:
        age(sessions - done)
        done = sessions
        print(f"after {sessions} profiler sessions:", flush=True)
        for label, (model, b) in models.items():
            trace(label, lambda: model.predict(b))
    return 0


if __name__ == "__main__":
    sys.exit(main())
