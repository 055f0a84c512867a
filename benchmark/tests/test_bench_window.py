"""The window's rate and 95th percentile move when one call of the window
stalls: every call and all of the window's time count."""

from __future__ import annotations

import time
import types

from benchmark import run


class _Event:
    """A CUDA event on the host clock: recorded when the call returned."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1000


FAKE_TORCH = types.SimpleNamespace(cuda=types.SimpleNamespace(
    synchronize=lambda: None, Event=_Event))


class _NoCapture:
    def arm(self, key):
        pass

    def outputs(self, out):
        pass


def _window(loop, stall_at=None, seconds=0.6, call_s=0.01, stall_s=0.25):
    n = [0]

    def call(batch):
        time.sleep(stall_s if n[0] == stall_at else call_s)
        n[0] += 1
        return {}
    return run.run_window(loop, call, [{}], seconds, 4, _NoCapture(), set(),
                          FAKE_TORCH)


def test_a_stall_lowers_the_rate():
    steady, stalled = _window("ahead"), _window("ahead", stall_at=5)
    assert stalled.samples < steady.samples - 4 * 10
    assert steady.samples % 4 == 0


def test_a_stall_raises_the_tail():
    steady = _window("closed", seconds=0.15)
    stalled = _window("closed", stall_at=3, seconds=0.15, stall_s=0.05)
    assert 10 <= len(steady.latencies_s) < 20
    # one stalled call of fewer than 20: the 95th percentile is that call
    assert run.percentile(stalled.latencies_s, 95) \
        > 2 * run.percentile(steady.latencies_s, 95)
    assert run.percentile(stalled.latencies_s, 50) \
        < 2 * run.percentile(steady.latencies_s, 50)


def test_percentile_is_nearest_rank():
    values = list(range(1, 101))
    assert run.percentile(values, 95) == 95
    assert run.percentile(values, 50) == 50
    assert run.percentile([3.0], 95) == 3.0
