"""The readings a cell's correctness limits are set from, on the card, in
one process (set-up is long):

    python3 -m benchmark.calibrate --workload lc_eval --seeds 1 2 3 \\
        --control-seeds 1 2 3 --seconds 5 --out chiprun_out/cal.jsonl

For each of ``--seeds`` it runs the cell as the benchmark does (a short
window at the cell's load, then the check) and writes the numbers
compared: their largest over a dozen seeds or more is a limit's lower
reading.  For each of ``--fault-seeds`` it runs the cell with a fault of
``faults.py`` planted under the timed path.  For each of ``--control-seeds`` it puts the control in the
port's place, the reference computed in fp8 (``reference/precision.py``),
on the batches a run samples, and writes the same numbers against the
float32 reference: their smallest is the upper reading.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from benchmark.spec import ROOT


def control_readings(cell, seed: int, device: str = "cuda"):
    """The control's numbers on ``seed``'s sampled batches (a training
    cell: over its first steps)."""
    import torch
    if cell.traffic["kind"] == "train":
        return _train_control(cell, seed, device)
    from benchmark import check, traffic, weights
    from benchmark.reference import build as ref_build, precision
    t = cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = os.path.join(ROOT, cell.config["config_file"])
    meta = ref_build.build_meta(path)
    from unibev_tpu_torch.flagship import model_cfg_from_config
    dtype = model_cfg_from_config(path)["dtype"]
    state = weights.make_state(meta, seed, device, dtype)
    ref = ref_build.build(path, state, device)
    ctl = ref_build.build(path, state, device)
    del state
    pool = traffic.make_pool(t, seed, device)
    gen = torch.Generator().manual_seed(seed)
    calls = check.sample_calls(gen, t["check_within"], t["pool"],
                               t["check_calls"])
    want, got = check.Capture(ref), check.Capture(ctl, forced=True)
    readings = []
    with torch.no_grad(), precision.fp8(ctl):
        for i in calls:
            batch = pool[i % len(pool)]
            want.arm(i)
            ref(batch)
            got.arm(i)
            ctl(batch)
            want.arm(None)
            got.arm(None)
            if device == "cuda":
                torch.cuda.synchronize()
            rec = got.records.pop(i)
            readings.append(dict(check.compare(rec, want.records.pop(i),
                                               t["batch"]),
                                 **check.forced(ref, rec, device)))
    return check.worst(readings)


def _train_control(cell, seed: int, device: str):
    import torch
    from benchmark import traffic, train, weights
    from benchmark.reference import build as ref_build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = cell.traffic
    path = os.path.join(ROOT, cell.config["config_file"])
    meta = ref_build.build_meta(path)
    pool = traffic.make_pool(t, seed, device)
    steps = t["compare_steps"]
    want = train.reference_readings(
        path, weights.make_state(meta, seed, device, torch.float32), seed,
        pool, steps, device)
    torch.cuda.empty_cache()
    got = train.reference_readings(
        path, weights.make_state(meta, seed, device, torch.float32), seed,
        pool, steps, device, control=True)
    return train.compare(got, want)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", default="half_batch",
                   help="the fault of --fault-seeds (benchmark/faults.py)")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    from benchmark import run
    run._set_caches()
    import torch
    from benchmark.spec import load_cell
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as out:
        for seed in args.seeds:
            t0 = time.perf_counter()
            r = run.run_cell(cell, seed, args.seconds, False,
                             t_start=time.perf_counter())
            line = dict(workload=cell.name, side="program", seed=seed,
                        numbers=r["numbers"], correct=r["correct"],
                        metrics=r["metrics"], seconds=time.perf_counter() - t0)
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
        from benchmark.faults import FAULTS
        for seed in args.fault_seeds:
            t0 = time.perf_counter()
            r = run.run_cell(cell, seed, args.seconds, False,
                             t_start=time.perf_counter(),
                             fault=FAULTS[args.fault])
            line = dict(workload=cell.name, side=f"fault {args.fault}",
                        seed=seed, numbers=r["numbers"], correct=r["correct"],
                        seconds=time.perf_counter() - t0)
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
        for seed in args.control_seeds:
            t0 = time.perf_counter()
            numbers = control_readings(cell, seed)
            line = dict(workload=cell.name, side="control", seed=seed,
                        numbers=numbers, seconds=time.perf_counter() - t0)
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
