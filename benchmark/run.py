"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root.  The run builds the cell's model through the
port's ``flagship.build_model_from_config`` with weights drawn from the
seed on the card, draws a pool of batches from the seed (``traffic.py``),
warms every shape up (set-up ends at the first timed call), and then drives
the port for ``--seconds``: an evaluation cell issues call n + 1 before it
reads call n's outputs back (``"loop": "ahead"``), a stream cell waits for
each call's outputs before it issues the next (``"loop": "closed"``).
Once the window has closed it reads the peak memory, and with ``--trace 1``
traces a few more calls with the benchmark's ranges in (``trace.py``,
``spans.py``) and reads the cell's per-layer metrics (``metrics/``).  Then
it frees the port, runs the plain reference on the sampled calls' batches
(``check.py``) and judges them.  The last line of standard output is the
result, JSON; the last lines of standard error are the numbers compared,
each with its limit.

It exits with a code other than 0 and prints no result when no CUDA card
is there (or fewer than the cell asks for), or when JAX or the JAX package
was loaded in the process.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# JAX and the JAX package may not be loaded; compared by whole top-level
# module names
FORBIDDEN = ("jax", "jaxlib", "flax", "unibev_tpu")
# caches of the libraries the port may use, at fixed paths in the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton_cache"}
GIB = 2 ** 30


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Window:
    """What the timed window measured."""
    seconds: float
    calls: int = 0                 # calls finished in the window
    samples: int = 0               # their samples
    attempted: int = 0             # samples issued in the window
    latencies_s: List[float] = field(default_factory=list)


@dataclass
class Context:
    """What a per-layer metric's reader reads."""
    window: Window
    trace: object = None                         # trace.Trace
    trace_samples: int = 0
    op_calls: Dict[str, list] = field(default_factory=dict)
    flops_per_sample: Optional[float] = None


def _to_host(out: Dict, keep: Dict) -> None:
    """Copy each output tensor to the host without waiting (pinned
    memory)."""
    import torch
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            keep[k] = v.to("cpu", non_blocking=True)


def run_window(loop: str, call: Callable, pool: List, seconds: float,
               samples: int, capture, armed, torch, depth: int = 2,
               calls: Optional[int] = None) -> Window:
    """Drive ``call`` over the pool for ``seconds`` (or for ``calls``
    calls, the traced part).  ``ahead``: call n + 1 is issued before call
    n's outputs are read; a sample counts when its call's outputs reached
    the host within the window (the device's event after the copy), and
    the window closes at the first such completion at or past
    ``seconds``.  ``closed``: each call waits for its outputs; every call
    issued in the window counts, with its latency from issue to outputs on
    the host."""
    w = Window(seconds)
    if calls is None:
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    i = 0

    def more() -> bool:
        return time.perf_counter() - t0 < seconds if calls is None \
            else i < calls

    def issue(keep: Dict) -> None:
        # the traced part marks each call, whose first and last calls the
        # trace leaves out of its window (the pipeline's fill and drain)
        if calls is None:
            _to_host(call(pool[i % len(pool)]), keep)
        else:
            with torch.profiler.record_function("call"):
                _to_host(call(pool[i % len(pool)]), keep)
        capture.outputs(keep)
    if loop == "closed":
        while more():
            capture.arm(i if i in armed else None)
            t_issue = time.perf_counter()
            keep: Dict = {}
            issue(keep)
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
            w.latencies_s.append(time.perf_counter() - t_issue)
            i += 1
        capture.arm(None)
        w.calls, w.samples = i, i * samples
        w.attempted = w.samples
        return w
    if loop != "ahead":
        raise ValueError(f"unknown loop {loop!r}")
    pending: deque = deque()
    finished = []
    while more():
        capture.arm(i if i in armed else None)
        keep = {}
        issue(keep)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        pending.append((ev, keep))
        if len(pending) >= depth:
            pending[0][0].synchronize()
            finished.append(pending.popleft()[0])
        i += 1
    capture.arm(None)
    while pending:
        pending[0][0].synchronize()
        finished.append(pending.popleft()[0])
    w.attempted = i * samples
    if calls is None:
        # the window closes at the first completion at or past ``seconds``
        # (the calls still in flight when the host stopped issuing reach
        # it), so that it holds whole calls and no rate is rounded to one
        done = [start.elapsed_time(ev) / 1000 for ev in finished]
        w.calls = next((k + 1 for k, t in enumerate(done) if t >= seconds),
                       len(done))
        w.seconds = done[w.calls - 1]
    w.samples = w.calls * samples
    return w


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def load_file(kind: str, name: str, here: str = HERE):
    """The module ``<here>/<kind>/<name>.py`` (a metric's reader, an op's
    work formula), found by name; names may hold dots."""
    path = os.path.join(here, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(name: str, window: Window, setup_s: float, peak: int
               ) -> Optional[float]:
    """An end-to-end metric by the form of its name: ``*samples_per_s``
    (the window's rate), ``latency_p<q>_ms`` (the q-th percentile of the
    window's latencies), ``peak_mem_gib``, ``setup_s``."""
    if name.endswith("samples_per_s"):
        return window.samples / window.seconds
    q = re.fullmatch(r"latency_p(\d+)_ms", name)
    if q:
        return (percentile(window.latencies_s, int(q.group(1))) * 1e3
                if window.latencies_s else None)
    return {"peak_mem_gib": peak / GIB, "setup_s": setup_s}.get(name)


def check_model(config: Dict, model) -> None:
    """Fail where the built model differs from the configuration file's
    shape-defining values (``expect``)."""
    from benchmark import shapes
    got = shapes.of_model(model)
    bad = {k: (got.get(k), v) for k, v in config["expect"].items()
           if got.get(k) != v}
    if bad:
        raise ValueError(f"the model built from {config['config_file']} "
                         f"differs from {config['name']}'s values (built, "
                         f"expected): {bad}")


def count_flops(ref, batch, torch) -> float:
    """Model operations of one reference forward over ``batch``: every
    product aten runs (``FlopCounterMode``) and the deformable attention's
    sampling (``work/msda_fwd.py``), which aten sees as grid_sample."""
    from torch.utils.flop_counter import FlopCounterMode
    from benchmark import spans
    from benchmark.reference.models.attention import deformable
    from benchmark.work import msda_fwd
    calls: List = []
    inner = deformable.ms_deform_attn
    deformable.ms_deform_attn = spans._wrap("op:msda_fwd", inner, calls,
                                            "ms_deform_attn")
    try:
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            ref(batch)
    finally:
        deformable.ms_deform_attn = inner
    return counter.get_total_flops() + sum(msda_fwd.work(c)[0] for c in calls)


class _NoCapture:
    """A training cell keeps no layer outputs: its check reads the steps."""
    records: Dict = {}

    def arm(self, key) -> None:
        pass

    def outputs(self, out) -> None:
        pass

    def remove(self) -> None:
        pass


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = PROCESS_START, fault: Optional[Callable] = None
             ) -> Dict:
    """One run of ``cell``; returns the result line's object, with the
    numbers compared (``numbers``) beside it.  ``fault``, for the harness's
    tests and the readings of a fault, wraps the call the window drives."""
    import torch
    from unibev_tpu_torch import flagship
    from unibev_tpu_torch.ops import _build
    from benchmark import check, spans, traffic, weights
    from benchmark import train as training
    from benchmark.reference import build as ref_build

    # set-up's phases, each as seconds from the start, for standard error
    phases: List = []

    def phase(name: str, sync: bool = True) -> None:
        if sync and device == "cuda":
            torch.cuda.synchronize()
        phases.append(f"{name} {time.perf_counter() - t_start:.3f}")
    phase("imports", sync=False)
    phase("context")
    t = cell.traffic
    train = t["kind"] == "train"
    config_file = os.path.join(ROOT, cell.config["config_file"])
    model = flagship.build_model_from_config(config_file, device="meta",
                                             train=train)
    check_model(cell.config, model)
    meta_ref = ref_build.build_meta(config_file)
    # the type the weights are served in: float32 master weights to train
    dtype = torch.float32 if train else \
        flagship.model_cfg_from_config(config_file)["dtype"]
    state = weights.make_state(meta_ref, seed, device, dtype)
    phase("weights")
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    phase("model")
    pool = traffic.make_pool(t, seed, device)
    phase("pool")
    samples = t["batch"]
    if train:
        from unibev_tpu_torch.parallel import train_state
        call, opt = training.build(model, config_file, seed, device,
                                   train_state)
        if fault is not None:
            call = fault(call, model)
        capture, armed = _NoCapture(), set()
        # the first steps, through the window's own call, are the warm-up
        steps = training.take_steps(call, model, opt, pool,
                                    t["compare_steps"], state)
    else:
        call = model.predict
        if fault is not None:
            call = fault(call, model)
        capture = check.Capture(model, forced=True)
        gen = torch.Generator().manual_seed(seed)
        armed = set(check.sample_calls(gen, t["check_within"], t["pool"],
                                       t["check_calls"]))
        # warm-up: every shape, and the pinned host buffers the copies reuse
        for i in range(t["warmup"]):
            capture.arm(-1 - i)
            _to_host(call(pool[i % len(pool)]), {})
        capture.arm(None)
        capture.records.clear()
    del state
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    phase("warm-up")
    print(f"set-up phases (s from the start): {', '.join(phases)}",
          file=sys.stderr, flush=True)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
        window = run_window(t["loop"], call, pool, seconds, samples, capture,
                            armed, torch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        window = run_window_cpu(call, pool, seconds, samples, capture, armed)
        peak = 0
    ctx = Context(window)
    if trace:
        from benchmark import trace as tr
        n = t["trace_calls"]
        with spans.install(model) as calls:
            ctx.trace = tr.traced(
                lambda: run_window(t["loop"], call, pool, 0.0, samples,
                                   capture, set(), torch, calls=n),
                lambda: _build.launches)
        spans.count_live(calls)
        print(f"trace: attempt {ctx.trace.attempts}, {ctx.trace.lost}",
              file=sys.stderr, flush=True)
        ctx.op_calls = calls
        ctx.trace_samples = n * samples
    capture.remove()
    model = call = opt = None
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the check, against the reference, TF32 off
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    state = weights.make_state(meta_ref, seed, device, dtype)
    if train:
        want = training.reference_readings(config_file, state, seed, pool,
                                           t["compare_steps"], device)
        numbers = training.compare(steps, want)
        for key, rows in training.worst_leaves(steps, want).items():
            print(f"largest {key} gaps (parameter, gap, port, reference): "
                  f"{rows}", file=sys.stderr, flush=True)
        if trace:
            ref = ref_build.build(config_file, state, device)
            # a step's model operations: the forward's and twice them for
            # the backward
            ctx.flops_per_sample = 3 * count_flops(ref, pool[0], torch) / samples
            del ref
    else:
        numbers = _check_predict(cell, ref_build.build(config_file, state,
                                                       device),
                                 capture, pool, device, trace, ctx, torch)
    del state
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    correct, rows = check.judge(numbers, cell.limits)
    check_s = time.perf_counter() - t_check

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = load_file("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = end_to_end(m["name"], window, setup_s, peak)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": window.attempted,
        "failed": 0 if correct else window.attempted,
        "metrics": metrics,
        "device": device_info(torch, peak, ctx if trace else None),
    }
    if trace:
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in ctx.trace.by_category()[:10]],
            "idle_gaps": [[n, s] for n, s in ctx.trace.idle_gaps[:10]]}
    result["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    result["numbers"] = numbers
    print(f"window: {window.calls} calls, {window.samples} samples in "
          f"{window.seconds} s; set-up {setup_s:.3f} s; check {check_s:.3f} s"
          f" over calls {sorted(capture.records) or 'the first steps'}",
          file=sys.stderr, flush=True)
    for k, v, lim in rows:
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    return result


def _check_predict(cell, ref, capture, pool, device, trace, ctx, torch
                   ) -> Dict[str, float]:
    """The reference on the sampled calls' batches: each call's numbers,
    the largest of each over the calls."""
    from benchmark import check
    t = cell.traffic
    ref_capture = check.Capture(ref)
    readings = []
    for i in sorted(capture.records):
        ref_capture.arm(i)
        with torch.no_grad():
            ref(pool[i % len(pool)])
        ref_capture.arm(None)
        if device == "cuda":
            torch.cuda.synchronize()
        got = capture.records[i]
        if "voxels" in got:
            print(f"call {i}: distinct voxels {got['voxels'].tolist()}, "
                  f"sparse overflow {got['overflow'].tolist()}",
                  file=sys.stderr, flush=True)
        readings.append(dict(check.compare(got, ref_capture.records.pop(i),
                                           t["batch"]),
                             **check.forced(ref, got, device)))
    if not readings:
        readings.append({k: float("inf") for k in cell.limits})
    if trace:
        ctx.flops_per_sample = count_flops(ref, pool[0], torch) / t["batch"]
    return check.worst(readings)


def run_window_cpu(call, pool, seconds, samples, capture, armed) -> Window:
    """The window on the CPU, for the harness's tests: calls in a closed
    loop until ``seconds`` have passed and every armed call has run."""
    w = Window(seconds)
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds or i <= max(armed, default=0):
        capture.arm(i if i in armed else None)
        t_issue = time.perf_counter()
        capture.outputs(call(pool[i % len(pool)]))
        w.latencies_s.append(time.perf_counter() - t_issue)
        i += 1
    capture.arm(None)
    w.calls = i
    w.samples = w.attempted = i * samples
    return w


def device_info(torch, peak: int, ctx: Optional[Context]) -> Dict:
    if not torch.cuda.is_available():
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": peak}
    if ctx is not None and ctx.trace is not None:
        info["busy_s"] = ctx.trace.busy_s
        info["window_s"] = ctx.trace.window_s
    return info


def _set_caches() -> None:
    for var, rel in CACHE_DIRS.items():
        path = os.path.join(ROOT, rel)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _set_caches()
    from benchmark.spec import load_cell
    cell = load_cell(args.workload)
    import torch
    need = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"no result: the cell needs {need} CUDA card(s), this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"no result: the process loaded {bad}", file=sys.stderr)
        return 3
    result.pop("numbers")
    compared = result["compared"]
    for v in compared.values():
        # a layer the port did not run reads infinity: null in JSON
        if not math.isfinite(v["value"]):
            v["value"] = None
    line = json.dumps(result)
    for k, v in compared.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
