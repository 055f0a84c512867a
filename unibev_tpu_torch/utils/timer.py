"""Timing and profiling helpers.

Counterpart of ``unibev_tpu/utils/timer.py``: ``run_time``, a decorator
printing the running average wall time of a call after the card has
finished it (``torch.cuda.synchronize`` where CUDA is up, the JAX one's
``block_until_ready``), ``timing_stats``, and ``profile_trace``, a
``torch.profiler`` chrome trace around a block.  The JAX module's
``start_profiler_server`` (a live trace server for TensorBoard) has no
PyTorch counterpart and is left out.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Callable, Dict

import torch

_TIME_STATS: Dict[str, list] = defaultdict(lambda: [0.0, 0])


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def run_time(name: str) -> Callable:
    """Decorator: the running average wall time of the function, its CUDA
    work included, printed after each call."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _synchronize()
            dt = time.perf_counter() - t0
            s = _TIME_STATS[name]
            s[0] += dt
            s[1] += 1
            print(f"[{name}] avg {s[0] / s[1] * 1e3:.2f} ms over {s[1]} calls")
            return out
        return inner

    return wrap


def timing_stats() -> Dict[str, float]:
    """Mean seconds per call of each name :func:`run_time` timed."""
    return {k: v[0] / max(v[1], 1) for k, v in _TIME_STATS.items()}


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where it is
    up), written to ``log_dir/trace.json`` for chrome://tracing or
    Perfetto; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
