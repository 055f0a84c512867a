#!/usr/bin/env python3
"""Time variants of the assignment kernel K12 (``csrc/lsa.cu``) on the
loss's problems and phase 19c's cases (b) and (c), on one CUDA card.

    python3 -m unibev_tpu_torch.tools.lsa_study [--parent DIR]

Each variant is a copy of ``csrc/lsa.cu`` with one text change (VARIANTS,
and one variant for each block width of 1, 4, 8, 16 and 32 warps that the
source does not set; one warp takes at most 1024 columns), built alone
into ``build/lsa_study/<name>/lib.so`` (one ``nvcc`` each, all started
together) and loaded with ctypes in place
of the library: the library carries no switches.  ``--parent DIR`` also
builds ``DIR/unibev_tpu_torch/csrc/lsa.cu`` (a checkout of an earlier
commit, for example one unpacked with ``git archive`` under ``build/``)
and times it beside the others.  One more copy, with ``clock64()`` marks
(MARKS), gives the median cycles of each phase of a Dijkstra step
(relaxation, the warp's argmin, the barrier, the warps' reduction; a
first step's staging wait and fast-path end), over every block's steps.

The cases are chip_smoke.py's ``lsa_cases``, made as phase 19c makes
them: (a) the problems of one ``head.loss`` of the flagship LC model (6 x
64 x 900, 40 valid rows a problem) after phase 18's 13 train steps (41-43
Dijkstra steps a problem, nearly all rows ending at their first step),
and "a fresh loss", the same at the seeded random weights (44-155 steps),
(b) 6 x 140 x 900 uniform costs with 0, 1, 35, 139, 140 valid rows and one
mask with holes, (c) the same masks on integer costs in [0, 8).  The
library kernel's col4row must equal the plain version's, and every
variant's the library kernel's, exactly; each is timed by the profiler's
device time and by CUDA events over back-to-back calls, in two rounds, the
second in reverse order.  Prints one line per variant and round, and writes
``chiprun_out/lsa_study.json``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from chip_smoke import (cuda_ms, device_ms, lsa_cases,  # noqa: E402
                        phase_flagship_train)
from unibev_tpu_torch.core.bbox.lsa import (  # noqa: E402
    linear_sum_assignment, solve_with_steps)
from unibev_tpu_torch.flagship import (build_flagship,  # noqa: E402
                                       synthetic_batch)
from unibev_tpu_torch.ops import _build  # noqa: E402
from unibev_tpu_torch.parallel.train_state import (  # noqa: E402
    compute_autocast)

OUT = os.path.join(ROOT, "build", "lsa_study")
_WARPS = re.compile(r"constexpr int kWarps = (\d+);")
_RING = "constexpr int kRing = 3;"
# ptxas -v on one kernel: its <warps, columns a lane>, spills, registers
_PTXAS = re.compile(r"lsa_kernelILi(\d+)ELi(\d+)E.*?(\d+) bytes spill stores"
                    r".*?Used (\d+) registers", re.S)
_RESIDENT = "  const int resident = n_slots - kRing;"
_KEYS = """  const unsigned key = __reduce_min_sync(0xffffffffu, order_key(best));
  const unsigned col = __reduce_min_sync(
      0xffffffffu,
      order_key(best) == key ? (unsigned)best_j : 0xffffffffu);"""

# name: [(text, its replacement), ...]
VARIANTS = {
    "kernel": [],
    # every row read from global memory (L2), nothing staged
    "no_staging": [
        (_RESIDENT, "  const int resident = 0;"),
        ("    if (n < n_valid) copy_row(n);", "    if (false) copy_row(n);"),
        ("int i = cur, s = slot_for(n), step = 0,",
         "int i = cur, s = -1, step = 0,")],
    # no resident rows: every row's first step from the ring, its later
    # steps from global memory (L2)
    "ring_only": [(_RESIDENT, "  const int resident = 0;")],
    # a ring of 2 or 4 staged rows
    "ring2": [(_RING, _RING.replace("3", "2"))],
    "ring4": [(_RING, _RING.replace("3", "4"))],
    # every row ends through the dual pass, a barrier and the walk
    "no_fast_path": [
        ("      if (next < 0 || step + 1 == C) break;\n      if (step == 0) {",
         "      if (step == 0) {"),
        ("      ++step;\n      i = next;",
         "      if (next < 0 || step + 1 == C) {\n        ++step;\n"
         "        break;\n      }\n      ++step;\n      i = next;")],
    # each valid row waits on a global read of its mask byte, as the
    # parent's loop over the rows did
    "mask_on_chain": [
        ("    const int cur = rows[n];\n",
         "    const int cur = rows[n];\n    if (!valid[(long long)blockIdx.x"
         " * R + cur]) continue;\n")],
    # the warps' words met in one 64-bit shared atomicMin (a slot a step,
    # three in turn, each reset two steps ahead) in place of a slot a warp
    "atomic_argmin": [
        ("  if (t < 32) {   // the valid rows, in order",
         "  if (t < 3) slots[t] = ~0ull;\n"
         "  if (t < 32) {   // the valid rows, in order"),
        ("""      half[threadIdx.x >> 5] = (unsigned long long)key << 32 | low;
    }
    __syncthreads();
    unsigned long long m = half[0];
#pragma unroll
    for (int w = 1; w < W; ++w) m = half[w] < m ? half[w] : m;
    slot ^= 1;""", """      atomicMin(&slots[slot], (unsigned long long)key << 32 | low);
    }
    __syncthreads();
    const unsigned long long m = slots[slot];
    if (threadIdx.x == 0) slots[slot == 0 ? 2 : slot - 1] = ~0ull;
    slot = slot == 2 ? 0 : slot + 1;""")],
    # the warps' words taken as a tree (log2(W) deep) in place of a chain
    "tree_reduce": [
        ("""    unsigned long long m = half[0];
#pragma unroll
    for (int w = 1; w < W; ++w) m = half[w] < m ? half[w] : m;""", """    unsigned long long h[W];
#pragma unroll
    for (int w = 0; w < W; ++w) h[w] = half[w];
#pragma unroll
    for (int step = 1; step < W; step *= 2)
#pragma unroll
      for (int w = 0; w + step < W; w += 2 * step)
        h[w] = h[w + step] < h[w] ? h[w + step] : h[w];
    const unsigned long long m = h[0];""")],
    # every row staged through the ring, none up front at the block's start
    "ring_staged_resident": [
        ("""  for (int n = 0; n < n_valid && n < resident; ++n) copy_row(n);
  cp_async_commit();
#pragma unroll
  for (int n = 0; n < kRing - 1; ++n) stage(resident + n);""",
         """  cp_async_commit();
#pragma unroll
  for (int n = 0; n < kRing - 1; ++n) stage(n);"""),
        ("    if (n >= resident) {\n      stage(n + kRing - 1);",
         "    {\n      stage(n + kRing - 1);")],
    # the relaxation with branches in place of selects
    "branchy_relax": [
        ("""    const bool live = (remaining >> k & 1u) && j < C;
    const float reduced = ((min_val + cost[k]) - ui) - v[k];
    const bool better = live && reduced < shortest[k];
    shortest[k] = better ? reduced : shortest[k];
    if (store_path && better) path[j] = i;
    const float masked = live ? shortest[k] : kInf;
    // j rises with k: the lowest column on ties
    const bool take = j < C && masked < best;
    best = take ? masked : best;
    best_j = take ? j : best_j;""", """    if (j < C) {
      float masked = kInf;
      if (remaining >> k & 1u) {
        const float reduced = ((min_val + cost[k]) - ui) - v[k];
        if (reduced < shortest[k]) {
          shortest[k] = reduced;
          if (store_path) path[j] = i;
        }
        masked = shortest[k];
      }
      if (masked < best) {
        best = masked;
        best_j = j;
      }
    }""")],
    # the warp's argmin by five rounds of xor shuffles of (key, column)
    "shuffle_argmin": [
        (_KEYS, """  unsigned key = order_key(best), col = (unsigned)best_j;
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned ok = __shfl_xor_sync(0xffffffffu, key, off);
    const unsigned oc = __shfl_xor_sync(0xffffffffu, col, off);
    if (ok < key || (ok == key && oc < col)) {
      key = ok;
      col = oc;
    }
  }""")],
}


# The library kernel with clock64() marks, thread 0 of each block, one
# record a Dijkstra step: 0 the step's start (for a first step, after its
# row's wait), 1 after its relaxation, 2 after the warp's two redux.sync,
# 3 after the barrier, 4 after the warps' words are reduced, and on a
# first step 5 the row's start, 6 after its staging wait, 7 the fast
# path's end.
_MARK_STEP = ("if (t == 0 && blockIdx.x < 8 && dbg < kMarkSteps) { mk = "
              "&g_marks[blockIdx.x][dbg++][0]; mk[0] = clock64(); mk[5] = "
              "mk[6] = mk[7] = 0; } else mk = nullptr;")
MARKS = [
    ("namespace {\n\n// warps",
     "constexpr int kMarkSteps = 2048;\n"
     "__device__ long long g_marks[8][kMarkSteps][8];\n"
     "namespace {\n\n// warps"),
    ("                                             int& next, float& min_val) {",
     "                                             int& next, float& min_val,"
     " long long* mk) {"),
    ("  if constexpr (W == 1) {\n    j_star = (int)col;",
     "  if (mk) mk[2] = clock64();\n  if constexpr (W == 1) {\n"
     "    j_star = (int)col;"),
    ("    __syncthreads();\n    unsigned long long m = half[0];",
     "    __syncthreads();\n    if (mk) mk[3] = clock64();\n"
     "    unsigned long long m = half[0];"),
    ("    min_val = key_value((unsigned)(m >> 32));\n  }\n}",
     "    min_val = key_value((unsigned)(m >> 32));\n  }\n"
     "  if (mk) mk[4] = clock64();\n}"),
    ("  for (int n = 0; n < n_valid; ++n) {\n    const int cur = rows[n];",
     "  int dbg = 0;\n  long long* mk = nullptr;\n"
     "  for (int n = 0; n < n_valid; ++n) {\n    " + _MARK_STEP.replace(
         "mk[5] = mk[6] = mk[7] = 0;", "mk[5] = mk[0]; mk[7] = 0;")
     + "\n    const int cur = rows[n];"),
    ("      cp_async_wait<kRing - 1>();   // row n's group is complete\n    }",
     "      cp_async_wait<kRing - 1>();   // row n's group is complete\n    }"
     "\n    if (mk) mk[6] = mk[0] = clock64();"),
    ("""                  path, C, best, best_j);
      block_argmin<W>(best, best_j, row4col, pend_j, pend_r, slots, slot,
                      j_star, next, min_val);""",
     """                  path, C, best, best_j);
      if (mk) mk[1] = clock64();
      block_argmin<W>(best, best_j, row4col, pend_j, pend_r, slots, slot,
                      j_star, next, min_val, mk);"""),
    ("      pend_j = j_star;\n      pend_r = cur;\n      continue;",
     "      pend_j = j_star;\n      pend_r = cur;\n"
     "      if (mk) mk[7] = clock64();\n      continue;"),
    ("      ++step;\n      i = next;",
     "      ++step;\n      " + _MARK_STEP + "\n      i = next;"),
]
_MARKS_API = """
extern "C" int lsa_marks(void* host, int zero) {
  static long long none[8 * kMarkSteps * 8];
  return (int)(zero ? cudaMemcpyToSymbol(g_marks, none, sizeof(g_marks))
                    : cudaMemcpyFromSymbol(host, g_marks, sizeof(g_marks)));
}
"""


def _edit(name, text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the text to change is not in "
                               f"lsa.cu once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _sources(parent):
    """{name: source text} of every variant, the widths and the parent's."""
    text = (_build.CSRC / "lsa.cu").read_text()
    found = _WARPS.findall(text)
    if len(found) != 1:
        raise RuntimeError("lsa.cu: no single kWarps constant")
    sources = {name: _edit(name, text, edits)
               for name, edits in VARIANTS.items()}
    sources["marks"] = _edit("marks", text, MARKS) + _MARKS_API
    for warps in (1, 4, 8, 16, 32):
        if warps != int(found[0]):   # one warp covers 1024 columns
            sources[f"warps{warps}"] = _WARPS.sub(
                f"constexpr int kWarps = {warps};", text).replace(
                    "constexpr int kMaxCols = 2048;",
                    f"constexpr int kMaxCols = {min(2048, 1024 * warps)};")
    if parent:
        with open(os.path.join(parent, "unibev_tpu_torch", "csrc",
                               "lsa.cu")) as f:
            sources["parent"] = f.read()
    return sources


def _build_all(sources):
    """{name: loaded library} of every variant, built in parallel."""
    nvcc = _build._nvcc()
    procs = {}
    for name, text in sources.items():
        path = os.path.join(OUT, name)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "lsa.cu"), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
             "-o", os.path.join(path, "lib.so"), os.path.join(path, "lsa.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log[-4000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        lib.unibev_lsa.argtypes = list(_build._SIGNATURES["unibev_lsa"])
        lib.unibev_lsa.restype = ctypes.c_int
        libs[name] = lib
        print(f"  built {name}: " + "; ".join(
            f"<{w}, {k}> {regs} registers, {spill} bytes spilled"
            for w, k, spill, regs in _PTXAS.findall(log)
            if int(k) <= 8), flush=True)
    return libs


def _loss_cases():
    """chip_smoke.py's three K12 cases, made as phase 19c makes them: case
    (a) from one forward of the flagship LC model after phase 18's 13
    train steps (and, as "a fresh loss", of the model at its seeded random
    weights, whose rows run more Dijkstra steps)."""
    model = build_flagship(use_lidar=True, device="cuda",
                           dtype=torch.bfloat16, seed=0, train=True)
    batch = synthetic_batch(np.random.RandomState(0), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad(), compute_autocast(model):
        preds = model(batch, gen)
    fresh = lsa_cases(model.pts_bbox_head, preds, batch)["a loss"]
    del model, preds, batch
    model, _, _, batch, gen, _ = phase_flagship_train(lidar=True)
    with torch.no_grad(), compute_autocast(model):
        preds = model(batch, gen)
    cases = lsa_cases(model.pts_bbox_head, preds, batch)
    cases["a fresh loss"] = fresh
    del model, preds, batch
    torch.cuda.empty_cache()
    return cases


def _marks(lib, cases, want):
    """{case: {first / later: median cycles of each phase}} of the marked
    kernel, over every block's steps; its col4row must equal ``want``."""
    lib.lsa_marks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = {}
    for case, (cost, valid) in cases.items():
        linear_sum_assignment(cost, valid)
        torch.cuda.synchronize()
        if lib.lsa_marks(None, 1):
            raise RuntimeError("lsa_marks: cudaMemcpyToSymbol failed")
        if not torch.equal(linear_sum_assignment(cost, valid), want[case]):
            raise AssertionError(f"marks {case}: col4row differs from the "
                                 f"library kernel's")
        rec = np.zeros((8, 2048, 8), np.int64)
        if lib.lsa_marks(rec.ctypes.data, 0):
            raise RuntimeError("lsa_marks: cudaMemcpyFromSymbol failed")
        rec = rec.reshape(-1, 8)
        rec = rec[rec[:, 0] != 0]
        first, later = rec[rec[:, 5] != 0], rec[rec[:, 5] == 0]
        out[case] = {}
        for kind, r in (("first", first), ("later", later)):
            if not len(r):
                continue
            d = np.diff(r[:, :5], axis=1)
            out[case][kind] = dict(
                steps=len(r), relax=float(np.median(d[:, 0])),
                redux=float(np.median(d[:, 1])),
                barrier=float(np.median(d[:, 2])),
                reduce=float(np.median(d[:, 3])))
        out[case]["first"].update(
            stage_wait=float(np.median(first[:, 6] - first[:, 5])))
        fast = first[first[:, 7] != 0]
        if len(fast):
            out[case]["first"]["fast_tail"] = float(
                np.median(fast[:, 7] - fast[:, 4]))
        print(f"  marks {case} (cycles, medians): " + "; ".join(
            f"{kind}: " + ", ".join(f"{k} {v:.0f}" for k, v in m.items())
            for kind, m in out[case].items()), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the root of an earlier checkout whose "
                    "lsa.cu is timed beside the variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lsa_study: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = _build_all(_sources(args.parent))
    library = _build.lib()
    cases = _loss_cases()
    want, steps = {}, {}
    for name, (cost, valid) in cases.items():
        want[name] = linear_sum_assignment(cost, valid)
        plain, n = solve_with_steps(cost.cpu(), valid.cpu())
        if not torch.equal(want[name].cpu(), plain):
            raise AssertionError(f"the library's K12 differs from the plain "
                                 f"version on {name}")
        steps[name] = n.tolist()
        print(f"  {name}: {tuple(cost.shape)}, valid rows "
              f"{valid.sum(1).tolist()}, Dijkstra steps {steps[name]}",
              flush=True)
    _build._lib = libs.pop("marks")
    try:
        marks = _marks(_build._lib, cases, want)
    finally:
        _build._lib = library
    rows = []
    try:
        for rnd, order in enumerate((list(libs), list(libs)[::-1])):
            for name in order:
                _build._lib = libs[name]
                row = dict(variant=name, round=rnd)
                for case, (cost, valid) in cases.items():
                    def run(c=cost, v=valid):
                        return linear_sum_assignment(c, v)
                    if not torch.equal(run(), want[case]):
                        raise AssertionError(f"{name} {case}: col4row differs "
                                             f"from the library kernel's")
                    iters = 3 if case.startswith("c") else 20
                    row[f"{case} device_ms"] = device_ms(run, iters)
                    row[f"{case} ms"] = cuda_ms(run, iters)
                rows.append(row)
                print(f"  {name} (round {rnd}): "
                      + ", ".join(f"{k} {v:.4f}" for k, v in row.items()
                                  if isinstance(v, float)), flush=True)
    finally:
        _build._lib = library
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "lsa_study.json"), "w") as f:
        json.dump(dict(gpu=smi, steps=steps, marks=marks, rows=rows), f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
