"""What the per-layer metrics' readers (``metrics/<name>.py``) share.

Each reader takes the run's ``Context`` (``run.py``) and returns a number,
or None where the run has nothing to read (the metric is then left out of
the result line).  Device times a sample come from every traced call, the
idle share and host time from the trace's window, its calls less the first
and the last (``trace.py``); rates from the untraced window.
"""

from __future__ import annotations

from typing import Optional

from benchmark import peaks


def layer_ms(ctx, layer: str) -> Optional[float]:
    """Device ms a sample of the kernels launched in ``layer`` itself."""
    s = ctx.trace.layer_s(layer) if ctx.trace else 0.0
    return s / ctx.trace_samples * 1e3 if s > 0 else None


def host_ms(ctx) -> Optional[float]:
    """Host ms a call of the trace's window, less its waiting CUDA calls."""
    if not ctx.trace or not ctx.trace.calls:
        return None
    return ctx.trace.host_s / ctx.trace.calls * 1e3


def idle_share(ctx) -> Optional[float]:
    """% of the trace's window in which no operation ran on the card."""
    if not ctx.trace or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def roofline(ctx, op: str) -> Optional[float]:
    """% of the least time the op's calls could take (``work/<op>.py``, the
    card's peaks) over the device time of every kernel launched inside
    their ranges."""
    calls = ctx.op_calls.get(op) or []
    device_s = ctx.trace.op_s(op) if ctx.trace else 0.0
    if not calls or device_s <= 0:
        return None
    from benchmark.run import load_file
    work = load_file("work", op).work
    bound = 0.0
    for c in calls:
        flops, nbytes, itemsize = work(c)
        bound += peaks.bound_s(flops, nbytes, itemsize)
    return 100.0 * bound / device_s


def mfu(ctx) -> Optional[float]:
    """% of the card's bf16 dense peak that the model's operations a sample
    (counted on the reference) at the window's rate make."""
    if not ctx.flops_per_sample or not ctx.window.samples:
        return None
    rate = ctx.window.samples / ctx.window.seconds
    return 100.0 * ctx.flops_per_sample * rate / peaks.BF16_FLOPS


def latency_ms(ctx, q: float) -> Optional[float]:
    from benchmark.run import percentile
    lat = ctx.window.latencies_s
    return percentile(lat, q) * 1e3 if lat else None
