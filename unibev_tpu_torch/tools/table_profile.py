#!/usr/bin/env python3
"""Device time of the sparse encoder's compact tables, by kernel, on one
CUDA card.

    python3 -m unibev_tpu_torch.tools.table_profile

Voxelizes chip_smoke.py's flagship cloud (300k points, 120,000 voxels on
[41, 1440, 1440]) and profiles the tables of one SparseEncoder forward
(``chip_smoke.py::_tables_of_a_forward``: ``build_table`` at res 0 and the
four ``downsample_with_table`` calls, one call of kernel K11 each, which
launches four ``__global__`` functions) after three warm-up runs.  Prints
their device time in all, the K11 calls counted by ``_build.launches``,
the 30 kernels that take the most of the time with their launches, and the
host's time in ``cudaLaunchKernel``; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from chip_smoke import _tables_of_a_forward, res0_grid  # noqa: E402
from unibev_tpu_torch.flagship import synthetic_batch  # noqa: E402
from unibev_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("table_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    points = synthetic_batch(np.random.RandomState(0), device="cuda")["points"][0]
    grid = res0_grid(points)[1]
    for _ in range(3):
        _tables_of_a_forward(grid)
    torch.cuda.synchronize()
    calls = _build.launches["active_set"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _tables_of_a_forward(grid)
        torch.cuda.synchronize()
    calls = _build.launches["active_set"] - calls
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels) / 1000
    launch = sum(e.self_cpu_time_total for e in events
                 if e.key == "cudaLaunchKernel") / 1000
    print(f"{torch.cuda.get_device_name(0)}: the tables of one forward, "
          f"{calls} K11 calls, device {total:.4f} ms in "
          f"{sum(e.count for e in kernels)} kernels; host {launch:.4f} ms in "
          f"cudaLaunchKernel")
    for e in kernels[:30]:
        print(f"  {e.self_device_time_total / 1000:8.4f} ms {e.count:4d}  "
              f"{e.key[:120]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
