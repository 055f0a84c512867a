"""The traced part of a run: ``torch.profiler`` over a few calls, and what is
read from it.

The profiler has dropped a long process's first device kernels, and once
the last ones (the port's ``chip_smoke.py`` found it); a run is one fresh
process, which lost none, and every trace here still opens with
``PRIMERS`` spin kernels and closes, once the traced calls have drained,
with ``TRAILERS`` more and ``SETTLE_S`` of host time.  None of them is
counted.  The hand kernels traced are held to the launches the port counted
(``unibev_tpu_torch.ops._build.launches``, by ``PROFILED_PER_CALL``): a
trace that differs is taken again, up to ``ATTEMPTS`` in all, and one that
still differs fails the run, so no reading rests on a short device time.

Each device event (kernel, copy, fill) is matched by its correlation id to
the host call that launched it, and so to the benchmark's ranges open at
that moment (``layer:<name>``, innermost first; ``op:<name>``).

The busy and idle time, the host's time and the idle gaps are read over
the trace's window: from the issue of the second traced call (a ``call``
range) to the issue of the last, so that the pipeline's fill before the
first call's kernels and its drain after the last call's issue are left
out; the window holds the calls between.  Device times a kernel or a layer
count every traced call.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

PRIMERS = 1024
TRAILERS = 256
SETTLE_S = 0.05
PRIMER_KERNEL = "spin_kernel"
ATTEMPTS = 3
# record_function ranges, which the profiler also lists as device events
RANGES = ("Optimizer.", "layer:", "op:", "call")
# the profiler's own ranges that stand for a layer: the autograd engine's
# nodes (the backward) and the optimizer's step
PROFILER_LAYERS = (("autograd::engine::evaluate_function", "layer:backward"),
                   ("Optimizer.step", "layer:optimizer"))
# host calls in which the host waits for the card
WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")

# The __global__ functions each hand kernel's C entry point launches a fixed
# number of times a call (alternative name fragments, count).
PROFILED_PER_CALL = {
    "msda_fwd": ((("msda_fwd_kernel",), 1),),
    "dcn_fwd": ((("dcn_fwd_kernel",), 1),),
    "dcn_im2col": ((("dcn_im2col_kernel",), 1),),
    "msda_bwd": ((("msda_bwd_kernel",), 1),),
    "dcn_bwd": ((("dcn_bwd_kernel",), 1),),
    "scatter_add_rows": ((("scatter_add_rows_kernel",), 1),),
    "sparse_nbr": ((("sparse_nbr_kernel",), 1),),
    "sparse_conv": ((("sparse_conv_kernel",), 1),),
    "sparse_inv_nbr": ((("sparse_inv_nbr_kernel",), 1),),
    "sparse_conv_wgrad": ((("sparse_wgrad",), 1),),
    "voxelize": ((("fill_words<10>",), 1), (("mark_points",), 1),
                 (("scan_tiles<10,",), 1), (("slot_points",), 1),
                 (("emit_voxels",), 1)),
    "active_set": ((("fill_words<11>",), 1), (("mark_rows", "mark_sites"), 1),
                   (("scan_tiles<11,",), 1),
                   (("build_rows", "emit_sites"), 1)),
    "lsa": ((("lsa_kernel",), 1),),
}


def category(kernel_name: str) -> str:
    """The breakdown's name of a device operation."""
    n = kernel_name.lower()
    if "lsa_kernel" in n:
        return "K12 lsa"
    if "msda_fwd" in n:
        return "K1 msda_fwd"
    if "dcn_fwd" in n:
        return "K2 dcn_fwd"
    if "dcn_im2col" in n:
        return "dcn_im2col (the DCN backward's columns)"
    if "msda_bwd" in n:
        return "K3 msda_bwd"
    if "dcn_bwd" in n:
        return "K4 dcn_bwd"
    if "scatter_add_rows" in n:
        return "K5 scatter_add_rows"
    if "sparse_inv_nbr" in n:
        return "K8 sparse_inv_nbr"
    if "sparse_wgrad" in n:
        return "K9 sparse_conv_wgrad"
    if "sparse_nbr" in n:
        return "K6 sparse_nbr"
    if "sparse_conv" in n:
        return "K7 sparse_conv"
    if any(k in n for k in ("<10>", "<10,", "mark_points", "slot_points",
                            "emit_voxels")):
        return "K10 voxelize"
    if any(k in n for k in ("<11>", "<11,", "mark_rows", "mark_sites",
                            "build_rows", "emit_sites")):
        return "K11 active_set"
    if "memcpy" in n or "memset" in n:
        return "copies and fills"
    if "sort" in n:
        return "sort (voxelizer, SCA top-K order)"
    if "index" in n or "scatter" in n or "scan" in n or "cum" in n:
        return "index_add, index_copy, scatter, scans"
    if "pool" in n:
        return "max pooling (ResNet stem)"
    if "fprop" in n or "dgrad" in n or "wgrad" in n or "conv" in n \
            or "addpadding" in n:
        return "convolution (cuDNN)"
    if "gemm" in n or "nvjet" in n or "cutlass" in n:
        return "matmul (cuBLAS)"
    return "elementwise, norms and other"


def prime(n: int) -> None:
    for _ in range(n):
        torch.cuda._sleep(1000)


@dataclass
class Trace:
    """What one traced part measured."""
    window_s: float                       # the window (see the doc)
    busy_s: float                         # union of device events in it
    host_s: float                         # window_s less the waiting calls
    calls: int                            # calls the window holds
    kernels: List[Tuple[str, float, Tuple[str, ...], Tuple[str, ...]]]
    # (name, device seconds, layer ranges innermost first, op ranges)
    idle_gaps: List[Tuple[str, float]]
    attempts: int
    lost: Dict[str, int] = field(default_factory=dict)

    def layer_s(self, layer: str) -> float:
        """Device seconds of the kernels launched inside ``layer:<layer>``
        and no layer range nested in it."""
        key = f"layer:{layer}"
        return sum(s for _, s, layers, _ in self.kernels
                   if layers and layers[0] == key)

    def op_s(self, op: str) -> float:
        """Device seconds of every kernel launched inside ``op:<op>``."""
        key = f"op:{op}"
        return sum(s for _, s, _, ops in self.kernels if key in ops)

    def by_category(self) -> List[Tuple[str, float]]:
        """Device seconds by :func:`category`, the largest first."""
        by: Dict[str, float] = {}
        for name, s, _, _ in self.kernels:
            by[category(name)] = by.get(category(name), 0.0) + s
        return sorted(by.items(), key=lambda kv: -kv[1])


def _losses(events, device) -> Dict[str, int]:
    """Primers kept before the work, trailers after it, and the kernel
    launches recorded on the host with no device record."""
    work = [i for i, e in enumerate(device) if PRIMER_KERNEL not in e.name()]
    spins = [i for i, e in enumerate(device) if PRIMER_KERNEL in e.name()]
    lead = sum(1 for i in spins if not work or i < work[0])
    trail = sum(1 for i in spins if work and i > work[-1])
    corr = {e.correlation_id() for e in device}
    launches = [e for e in events if _is_launch(e.name())]
    lost = sum(1 for e in launches if e.correlation_id() not in corr)
    return dict(primers=lead, trailers=trail, launches=len(launches), lost=lost)


def _is_launch(name: str) -> bool:
    return "LaunchKernel" in name or "LaunchCooperativeKernel" in name


def _counts(device, launched: Dict[str, int]) -> Dict[str, Tuple[int, int]]:
    """{kernel: (traced __global__ launches, expected)}."""
    out = {}
    for key, calls in launched.items():
        for names, per in PROFILED_PER_CALL.get(key, ()):
            got = sum(1 for e in device if any(f in e.name() for f in names))
            out[f"{key} {'|'.join(names)}"] = (got, per * calls)
    return out


def _range_name(name: str) -> str:
    """The benchmark's name of a host range, or '' for other events."""
    if name.startswith(("layer:", "op:")):
        return name
    for prefix, layer in PROFILER_LAYERS:
        if name.startswith(prefix):
            return layer
    return ""


def _analyse(prof, wall_s: float, attempts: int, lost) -> Trace:
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    device = sorted((e for e in events if e.device_type() == DeviceType.CUDA
                     and PRIMER_KERNEL not in e.name()
                     and not e.name().startswith(RANGES)),
                    key=lambda e: e.start_ns())
    by_corr = {e.correlation_id(): e for e in cpu
               if e.correlation_id() and e.name().startswith("cuda")}
    ranges = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(),
                      _range_name(e.name()), e.start_thread_id())
                     for e in cpu if _range_name(e.name())),
                    key=lambda r: r[0])
    starts = [r[0] for r in ranges]
    kernels = []
    for e in device:
        launch = by_corr.get(e.correlation_id())
        t = launch.start_ns() if launch is not None else e.start_ns()
        thread = launch.start_thread_id() if launch is not None else None
        open_ = [r for r in ranges[:bisect.bisect_right(starts, t)]
                 if r[1] >= t and thread in (None, r[3])]
        layers = tuple(r[2] for r in sorted(
            (r for r in open_ if r[2].startswith("layer:")),
            key=lambda r: -r[0]))
        ops = tuple(r[2] for r in open_ if r[2].startswith("op:"))
        kernels.append((e.name(), e.duration_ns() / 1e9, layers, ops))
    # the window: the second call's issue to the last call's (the whole
    # traced part where fewer than three calls are marked)
    issues = sorted(e.start_ns() for e in cpu if e.name() == "call")
    if len(issues) >= 3:
        lo, hi, calls = issues[1], issues[-1], len(issues) - 2
    else:
        lo = min((e.start_ns() for e in device), default=0)
        hi = lo + int(wall_s * 1e9)
        calls = len(issues)
    # busy: the union of the device intervals in the window; gaps between
    spans = []
    for e in device:
        a = max(e.start_ns(), lo)
        b = min(e.start_ns() + e.duration_ns(), hi)
        if b <= a:
            continue
        if spans and a <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], b)
        else:
            spans.append([a, b])
    busy = sum(b - a for a, b in spans) / 1e9
    window = (hi - lo) / 1e9
    host_ops = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                       for e in cpu if e.duration_ns() > 0),
                      key=lambda r: r[0])
    host_starts = [r[0] for r in host_ops]
    gaps = []
    for (_, a), (b, _) in zip(spans, spans[1:]):
        inside = [r for r in host_ops[:bisect.bisect_right(host_starts, a)]
                  if r[1] >= a and not r[2].startswith("call")]
        what = min(inside, key=lambda r: r[1] - r[0])[2] if inside else "host idle"
        gaps.append((what, (b - a) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    waits = sum(max(0, min(e.start_ns() + e.duration_ns(), hi)
                    - max(e.start_ns(), lo))
                for e in cpu if e.name() in WAIT_CALLS) / 1e9
    return Trace(window_s=window, busy_s=busy, host_s=window - waits,
                 calls=calls, kernels=kernels, idle_gaps=gaps[:10],
                 attempts=attempts, lost=lost)


def traced(run: Callable[[], None], launches: Callable[[], Dict[str, int]]
           ) -> Trace:
    """Trace ``run`` (its calls, ending in a synchronize) and read it;
    ``launches()`` is the port's launch counter.  Raises when every
    attempt's hand kernels differ from their launches."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    wrong = {}
    for attempt in range(1, ATTEMPTS + 1):
        before = dict(launches())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prime(PRIMERS)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prime(TRAILERS)
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)
        after = launches()
        launched = {k: v - before.get(k, 0) for k, v in after.items()
                    if v != before.get(k, 0)}
        events = list(prof.profiler.kineto_results.events())
        device = [e for e in events if e.device_type() == DeviceType.CUDA
                  and not e.name().startswith(RANGES)]
        wrong = {k: v for k, v in _counts(device, launched).items()
                 if v[0] != v[1]}
        lost = _losses(events, sorted(device, key=lambda e: e.start_ns()))
        if not wrong and not lost["lost"] and lost["primers"] \
                and lost["trailers"]:
            return _analyse(prof, wall, attempt, lost)
    raise RuntimeError(f"the trace lost device records in each of {ATTEMPTS}"
                       f" attempts (traced, launched: {wrong}; {lost})")
