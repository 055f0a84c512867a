"""The trace's window: from the second traced call's issue to the last
call's, so that the pipeline's fill and drain stay out of the idle share
and the host's time a call."""

from __future__ import annotations

import types

import pytest
from torch.autograd import DeviceType

from benchmark import trace

MS = 1_000_000


def _event(name, start_ms, dur_ms, device=DeviceType.CPU, corr=0):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: int(start_ms * MS),
        duration_ns=lambda: int(dur_ms * MS), device_type=lambda: device,
        correlation_id=lambda: corr, start_thread_id=lambda: 1)


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=results))


def test_window_leaves_out_the_first_and_last_call():
    events = []
    # four calls issued 10 ms apart; each launches one 6 ms kernel, but the
    # first kernel waits 20 ms behind the fill and the last runs long after
    for i, (issue, k_start) in enumerate([(0, 20), (10, 28), (20, 40),
                                          (30, 100)]):
        events.append(_event("call", issue, 1))
        events.append(_event("cudaLaunchKernel", issue + 0.5, 0.1, corr=i + 1))
        events.append(_event("k", k_start, 6, DeviceType.CUDA, corr=i + 1))
    events.append(_event("cudaDeviceSynchronize", 31, 75))
    t = trace._analyse(_prof(events), 0.106, 1, {})
    # the window: 10 ms to 30 ms, two calls; the kernel at 20 ms falls in
    # it whole, the one at 28 ms for its first 2 ms
    assert t.calls == 2
    assert t.window_s == pytest.approx(0.020)
    assert t.busy_s == pytest.approx(0.008)
    assert t.host_s == pytest.approx(0.020)
    # every kernel still counts for the layers' and ops' device times
    assert sum(s for _, s, _, _ in t.kernels) == pytest.approx(0.024)
