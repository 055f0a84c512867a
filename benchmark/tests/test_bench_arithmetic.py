"""The roofline and mfu arithmetic on hand-worked shapes."""

from __future__ import annotations

import types

import pytest

from benchmark import peaks, readers
from benchmark.run import Window, load_file


def test_dcn_fwd_work_by_hand():
    # B=1, 4x5 input and output, Cin 8, Cout 16, 9 taps, bf16
    call = dict(args=[((1, 4, 5, 8), 2), ((1, 4, 5, 18), 2),
                      ((1, 4, 5, 9), 2), ((72, 16), 2)],
                out=((1, 4, 5, 16), 2))
    flops, nbytes, itemsize = load_file("work", "dcn_fwd").work(call)
    assert flops == 2 * 20 * 9 * 8 * 16 + 8 * 20 * 9 * 8
    assert nbytes == 2 * (20 * 8 + 20 * 18 + 20 * 9 + 72 * 16 + 20 * 16)
    assert itemsize == 2


def test_msda_fwd_work_by_hand():
    # B=1, V=100, 2 heads of D 4, Q 3 queries, 1 level, 2 points
    call = dict(args=[((1, 100, 2, 4), 2), None, ((1, 3, 2, 1, 2, 2), 4),
                      ((1, 3, 2, 1, 2), 2)], out=((1, 3, 8), 2))
    flops, nbytes, _ = load_file("work", "msda_fwd").work(call)
    pts = 12
    assert flops == 8 * 4 * pts
    # 4 corner rows a point (4 * 12 * 2 * 4 = 384) are fewer than the map
    assert nbytes == 4 * pts * 2 * 4 + pts * (8 + 2) + 2 * 3 * 8


def test_sparse_conv_work_by_hand():
    conv = dict(fn="sparse_conv", args=[((10, 4), 2), ((6, 27), 4),
                                        ((108, 8), 2), ((6,), 1)],
                out=((6, 8), 2), live=30)
    flops, nbytes, _ = load_file("work", "sparse_conv").work(conv)
    assert flops == 2 * 30 * 4 * 8
    assert nbytes == 2 * 40 + 4 * 162 + 2 * 864 + 6 + 2 * 48
    rulebook = dict(fn="subm_neighbor_idx", args=[None, None],
                    out=((6, 27), 4))
    assert load_file("work", "sparse_conv").work(rulebook) == (
        0, 4 * 162 + 17 * 6, 2)


def test_roofline_share_by_hand():
    # 1e12 operations in bf16: 1.0111 ms at 989 TFLOP/s; 2 ms of kernels
    trace = types.SimpleNamespace(op_s=lambda op: 2e-3)
    ctx = types.SimpleNamespace(
        trace=trace, op_calls={"fake": [{}]},
        window=None)
    import benchmark.readers as r
    real = r.__dict__.get("load_file")
    share = None
    try:
        import benchmark.run as run_mod
        orig = run_mod.load_file
        run_mod.load_file = lambda kind, name, here=None: types.SimpleNamespace(
            work=lambda call: (1e12, 1.0, 2))
        share = readers.roofline(ctx, "fake")
    finally:
        run_mod.load_file = orig
    assert real is None
    assert share == pytest.approx(100 * (1e12 / peaks.BF16_FLOPS) / 2e-3)
    # bytes bound: 3.35e9 bytes take 1 ms
    assert peaks.bound_s(0, 3.35e9, 2) == pytest.approx(1e-3)
    assert peaks.bound_s(67e9, 0, 4) == pytest.approx(1e-3)


def test_mfu_by_hand():
    # 3.3e12 operations a sample at 30 samples/s: 99 TFLOP/s of 989
    w = Window(seconds=10.0, samples=300)
    ctx = types.SimpleNamespace(flops_per_sample=3.3e12, window=w)
    assert readers.mfu(ctx) == pytest.approx(100 * 99e12 / 989e12)


def test_idle_share_and_host_ms_by_hand():
    trace = types.SimpleNamespace(window_s=0.5, busy_s=0.4, host_s=0.3,
                                  calls=3)
    ctx = types.SimpleNamespace(trace=trace)
    assert readers.idle_share(ctx) == pytest.approx(20.0)
    assert readers.host_ms(ctx) == pytest.approx(100.0)
