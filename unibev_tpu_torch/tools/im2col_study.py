#!/usr/bin/env python3
"""Time variants of the DCN backward's column kernel ``dcn_im2col`` at the
flagship sites, on one CUDA card.

    python3 -m unibev_tpu_torch.tools.im2col_study [--parent DIR]

Each variant is a copy of ``csrc/deform_conv.cu`` with one text change
(VARIANTS), built alone into ``build/im2col_study/<name>.so`` (one ``nvcc``
each, all started together) and loaded with ctypes: the library carries no
switches.  ``--parent DIR`` also builds ``DIR/unibev_tpu_torch/csrc/
deform_conv.cu`` (a checkout of an earlier commit, for example one
unpacked with ``git archive`` under ``build/``), whose im2col entry point
takes no plan, and times it beside the others.

At stage 3 (6 x 58 x 100, Cin 256) and stage 4 (6 x 29 x 50, Cin 512) in
bf16, with chip_smoke.py's inputs (std-2 offsets, uniform mask), every
variant's columns must equal the library kernel's bit for bit (the
parent's within 2^-6 of the largest value); each is timed by CUDA events
over back-to-back calls and by the profiler's device time, with the mask
and with mask 0 (no corner read), in four rounds, every other one in
reverse order.  The library's wrapper (``deform_im2col``) is timed by events and
by its host time a call.  Prints one line per (site, variant) and the sums
over the 26 launches of a train step (23 stage-3 and 3 stage-4 calls), and
writes
``chiprun_out/im2col_study.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from chip_smoke import (DCN_SITES, _dcn_inputs, cuda_ms,  # noqa: E402
                        device_ms)
from unibev_tpu_torch.ops import _build  # noqa: E402
from unibev_tpu_torch.ops.deform_conv import (deform_im2col,  # noqa: E402
                                              im2col_plan)

OUT = os.path.join(ROOT, "build", "im2col_study")

# the corner loads without the L2 evict-last policy (16-byte path)
_PLAIN_LOADS = ("          corner[j][c] = load_last(src, policy);",
                "          corner[j][c] = __ldg(reinterpret_cast<const uint4*>(src));")
_STORE16 = ("__stcs(reinterpret_cast<uint4*>(dst), blend<T>(corner[j], w[j]));",
            "*reinterpret_cast<uint4*>(dst) = blend<T>(corner[j], w[j]);")
_BATCH = "constexpr int kColBatch = 2;"
_UNITS = "constexpr int kColUnits = 16;"
# The tile's columns staged in shared memory and written by TMA bulk copies
# (cp.async.bulk.global.shared::cta): each warp's lanes put a batch step's
# vectors into its slots, and lane 0 copies each step's 512 contiguous bytes
# once the previous copies have read the slots.  Only for rows of whole
# warps of 16-byte vectors (the flagship sites); the other instantiations
# keep their stores.
_BULK = [
    ("pixels * K * kColGeoBytes, s>>>(",
     "pixels * K * kColGeoBytes + 16 + kColThreads * kColBatch * 16, s>>>("),
    ("""      if constexpr (kVec)
        __stcs(reinterpret_cast<uint4*>(dst), blend<T>(corner[j], w[j]));
      else
        store_blend(dst, corner[j], w[j]);
    }
  }
}""",
     """      if constexpr (!kVec) store_blend(dst, corner[j], w[j]);
    }
    if constexpr (kVec) {
      uint4* const slots =
          reinterpret_cast<uint4*>(
              (reinterpret_cast<uintptr_t>(geo_row + pixels * K) + 15) &
              ~uintptr_t(15)) + (tid >> 5) * kColBatch * 32;
      if ((tid & 31) == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kColBatch; ++j)
        if (it[j] < items) slots[j * 32 + (tid & 31)] = blend<T>(corner[j], w[j]);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if ((tid & 31) == 0) {
#pragma unroll
        for (int j = 0; j < kColBatch; ++j)
          if (it[j] < items)
            asm volatile(
                "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], 512;"
                ::"l"(tile + (long long)it[j] * Cin + ch[j]),
                "r"(smem_u32(slots + j * 32)) : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
  }
  if ((tid & 31) == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}"""),
]

# name: [(text of csrc/deform_conv.cu, its replacement), ...]
VARIANTS = {
    "kernel": [],
    "batch1": [(_BATCH, "constexpr int kColBatch = 1;")],
    "batch4": [(_BATCH, "constexpr int kColBatch = 4;")],
    "units8": [(_UNITS, "constexpr int kColUnits = 8;")],
    "units32": [(_UNITS, "constexpr int kColUnits = 32;")],
    "no_evict_last": [_PLAIN_LOADS],
    "plain_stores": [_STORE16],
    "bulk_store": _BULK,
}

# the vectors a thread writes a tile (kColUnits) where a variant changes it
UNITS = {"units8": 8, "units32": 32}

_P, _I = ctypes.c_void_p, ctypes.c_int


def _build_all(parent):
    """{name: (.so path, ptxas lines of the im2col)} of every variant (and
    the parent's source), built in parallel."""
    os.makedirs(OUT, exist_ok=True)
    base = (_build.CSRC / "deform_conv.cu").read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        src = base
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the text to change is not in "
                                   f"csrc/deform_conv.cu once: {old[:60]!r}")
            src = src.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        jobs[name] = (path, str(_build.CSRC))
    if parent:
        csrc = os.path.join(parent, "unibev_tpu_torch", "csrc")
        jobs["parent"] = (os.path.join(csrc, "deform_conv.cu"), csrc)
    procs = {}
    for name, (src, inc) in jobs.items():
        so = os.path.join(OUT, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", inc, "-shared", "-o",
             so, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines, on = [], False
        for line in log.splitlines():
            if "Compiling entry function" in line:
                on = "dcn_im2col" in line
            if on and ("Used" in line or "spill" in line):
                lines.append(line.strip())
        built[name] = (so, lines)
    return built


def _loader(so, old):
    fn = ctypes.CDLL(so).unibev_dcn_im2col
    fn.argtypes = [_P] * 4 + [_I] * (12 if old else 15) + [_P]
    fn.restype = _I

    def run(x, off, mask, cols, plan):
        B, H, W, Cin = x.shape
        args = [x.data_ptr(), off.data_ptr(), mask.data_ptr(),
                cols.data_ptr(), B, H, W, Cin, H, W, 3, 3, 1, 1, 1, 1]
        if not old:
            args += [plan.vec_bytes // 2, plan.lanes, plan.pixels]
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{so}: launch failed with error {err}")
    return run


def main(argv):
    if not torch.cuda.is_available():
        print("im2col_study: no CUDA device", file=sys.stderr)
        return 1
    parent = None
    if argv[:1] == ["--parent"] and len(argv) == 2:
        parent = argv[1]
    elif argv:
        print(f"im2col_study: unknown arguments {argv}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    built = _build_all(parent)
    for name, (_, lines) in built.items():
        for line in lines:
            print(f"  ptxas {name}: {line}", flush=True)
    runs = {name: _loader(so, name == "parent") for name, (so, _) in built.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for site, calls, B, H, W, Cin, _ in DCN_SITES:
        x, off, mask = _dcn_inputs(gen, B, H, W, Cin, torch.bfloat16)
        zero = torch.zeros_like(mask)
        want = deform_im2col(x, off, mask)
        plan = im2col_plan(B, H, W, Cin, H, W, 9, 2, x.data_ptr(),
                           want.data_ptr())
        cols = torch.empty_like(want)
        plans = {}
        for name in runs:
            units = UNITS.get(name, 16)
            pixels = units * plan.threads // (plan.lanes * 9 *
                                              plan.chunks_per_lane)
            plans[name] = plan._replace(pixels=max(1, min(pixels, 128)))
        for name, run in runs.items():
            cols.fill_(float("nan"))
            run(x, off, mask, cols, plans[name])
            torch.cuda.synchronize()
            if name == "parent":
                err = (cols.float() - want.float()).abs().max().item()
                tol = 2 ** -6 * max(1.0, want.float().abs().max().item())
                if not err <= tol:
                    raise AssertionError(f"{site} parent: error {err} > {tol}")
            elif not torch.equal(cols, want):
                raise AssertionError(f"{site} {name}: other columns")
        rows = {name: dict(ms=[], device_ms=[], no_loads_ms=[],
                           no_loads_device_ms=[]) for name in runs}
        for order in (list(runs), list(runs)[::-1]) * 2:
            for name in order:
                r, run, p = rows[name], runs[name], plans[name]
                for key, m, timer in (("ms", mask, cuda_ms),
                                      ("device_ms", mask, device_ms),
                                      ("no_loads_ms", zero, cuda_ms),
                                      ("no_loads_device_ms", zero, device_ms)):
                    r[key].append(timer(
                        lambda m=m: run(x, off, m, cols, p), 20))
        for name, r in rows.items():
            mean = {k: sum(v) / len(v) for k, v in r.items()}
            results.setdefault(name, {})[site] = dict(calls=calls, **mean,
                                                      rounds=r)
            print(f"  {site} {name}: {mean['ms']:.4f} ms (device "
                  f"{mean['device_ms']:.4f}; rounds "
                  f"{', '.join(f'{v:.4f}' for v in r['device_ms'])}), mask 0 "
                  f"{mean['no_loads_ms']:.4f} "
                  f"ms (device {mean['no_loads_device_ms']:.4f}) x{calls}",
                  flush=True)
        # the library's wrapper: events over back-to-back calls (max of its
        # host time and the kernel's), and its host time a call
        lib = dict(ms=cuda_ms(lambda: deform_im2col(x, off, mask), 20),
                   no_loads_ms=cuda_ms(lambda: deform_im2col(x, off, zero), 20))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            deform_im2col(x, off, mask)
        lib["host_ms"] = (time.perf_counter() - t0) * 1e3 / 50
        torch.cuda.synchronize()
        results.setdefault("wrapper", {})[site] = dict(calls=calls, **lib)
        print(f"  {site} wrapper (deform_im2col): {lib['ms']:.4f} ms, mask 0 "
              f"{lib['no_loads_ms']:.4f} ms; host {lib['host_ms']:.4f} ms a "
              f"call", flush=True)
        del x, off, mask, zero, want, cols
        torch.cuda.empty_cache()
    print("the 26 launches of a train step:", flush=True)
    for name, sites in results.items():
        keys = ("ms", "no_loads_ms", "host_ms") if name == "wrapper" else (
            "ms", "device_ms", "no_loads_ms", "no_loads_device_ms")
        tot = {k: sum(s["calls"] * s[k] for s in sites.values()) for k in keys}
        sites["step"] = tot
        print(f"  {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()),
              flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "im2col_study.json"), "w") as f:
        json.dump(dict(gpu=smi, ptxas={n: b[1] for n, b in built.items()},
                       results=results), f, indent=1)
    shutil.rmtree(OUT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
