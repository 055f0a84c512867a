#!/usr/bin/env python3
"""Time variants of the bitmap scan that the voxelizer K10 and the compact
tables K11 share (``csrc/bitmap.cuh``) at their flagship sites, on one CUDA
card.

    python3 -m unibev_tpu_torch.tools.bitmap_study

Each variant is a copy of ``csrc/bitmap.cuh`` (and, for K10's base per
word, of ``csrc/voxelize.cu``) with one text change (VARIANTS), built with
``csrc/voxelize.cu`` and ``csrc/active_set.cu`` alone into
``build/bitmap_study/<name>/lib.so`` (one ``nvcc`` each, all started
together) and loaded with ctypes in place of the library: the library
carries no switches.  A variant that changes the tile's words runs with the
plans made for its tile (``_build.BITMAP_TILE_WORDS``).

At K10's LiDAR site (chip_smoke.py's flagship cloud, 300k points on the
[1440, 1440, 40] grid) and radar site (the RC batch's 2,048 points on 180 x
180 pillars), and at K11's 5 calls of one SparseEncoder forward, every
variant's outputs must equal the library kernel's bit for bit; each is
timed by the profiler's device time, the scan's own too, in two rounds,
the second in reverse order.  Prints one line per variant and round, and
writes ``chiprun_out/bitmap_study.json``.  Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from chip_smoke import (CAPACITIES, PC_RANGE, RADAR_GRID,  # noqa: E402
                        RADAR_LAYER, STRIDED_CONVS, VOXEL_GRID, VOXEL_SIZE,
                        _rc_batch, device_by_kernel, res0_grid)
from unibev_tpu_torch.flagship import synthetic_batch  # noqa: E402
from unibev_tpu_torch.ops import _build, sparse_conv, voxelize  # noqa: E402
from unibev_tpu_torch.ops.sparse_conv import SparseGrid  # noqa: E402

OUT = os.path.join(ROOT, "build", "bitmap_study")
_THREADS = "constexpr int kScanThreads = 256;"

# name: ({source file: [(text, its replacement), ...]}, the tile's words)
VARIANTS = {
    "kernel": ({}, 8192),
    # a tile of 2048 or 4096 words: 64 or 128 threads of 32 words
    "tile2048": ({"bitmap.cuh": [(_THREADS, _THREADS.replace("256", "64"))]},
                 2048),
    "tile4096": ({"bitmap.cuh": [(_THREADS,
                                  _THREADS.replace("256", "128"))]}, 4096),
    # four windows of 32 predecessors loaded a look-back step
    "four_windows": ({"bitmap.cuh": [("constexpr int kLookBackWindows = 1;",
                                      "constexpr int kLookBackWindows = 4;")]},
                     8192),
    # the status words polled with relaxed loads (flag and value are one
    # 64-bit word, so a relaxed load reads them together)
    "relaxed": ({"bitmap.cuh": [("ld.acquire.gpu.global.u64",
                                 "ld.relaxed.gpu.global.u64")]}, 8192),
    # K10 with a base per word (10.4 MB at the LiDAR grid) in place of its
    # count per 8-word sector
    "k10_word_base": ({"voxelize.cu": [
        ("scan_tiles<10, 8>", "scan_tiles<10, 1>"),
        ("sector_rank(a.bits, a.dir, key)", "bitmap_rank(a.bits, a.dir, key)"),
        ("e[kKeysOffset] = e[kDirOffset] + e[kPadded] / 8;",
         "e[kKeysOffset] = e[kDirOffset] + e[kPadded];")]}, 8192),
}
SOURCES = ("bitmap.cuh", "voxelize.cu", "active_set.cu")


def _build_all():
    """{name: loaded library} of every variant, built in parallel."""
    nvcc = _build._nvcc()
    procs = {}
    for name, (edits, _) in VARIANTS.items():
        path = os.path.join(OUT, name)
        os.makedirs(path, exist_ok=True)
        for src in SOURCES:
            text = (_build.CSRC / src).read_text()
            for old, new in edits.get(src, []):
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: the text to change is not in "
                                       f"{src} once: {old[:60]!r}")
                text = text.replace(old, new)
            with open(os.path.join(path, src), "w") as f:
                f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
             os.path.join(path, "lib.so"), os.path.join(path, "voxelize.cu"),
             os.path.join(path, "active_set.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log[-4000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        for entry in ("unibev_voxelize", "unibev_active_set"):
            getattr(lib, entry).argtypes = list(_build._SIGNATURES[entry])
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _use(lib, tile):
    """Route the wrappers to ``lib``, with plans for tiles of ``tile``
    words."""
    _build._lib = lib
    _build.BITMAP_TILE_WORDS = tile
    voxelize.voxelize_plan.cache_clear()
    sparse_conv.active_set_plan.cache_clear()


def _k10_plan(name, points, args):
    plan = voxelize.voxelize_plan(*points.shape, tuple(args[2]), *args[3:])
    if name == "k10_word_base":     # the counts take padded words, not / 8
        grow = plan.padded - plan.padded // 8
        plan = plan._replace(keys_offset=plan.keys_offset + grow,
                             slots_offset=plan.slots_offset + grow,
                             work_words=plan.work_words + grow)
    return plan


def _sites(name, clouds, grid):
    """{site: run} of K10's two sites and K11's 5 calls under the routed
    library."""
    sites = {}
    for site, (points, mask, args) in clouds.items():
        cell = voxelize._cell_args(tuple(args[0]), tuple(args[1]))
        plan = _k10_plan(name, points, args)
        sites[f"k10_{site}"] = (
            lambda p=points, m=mask, c=cell, pl=plan:
            voxelize._voxelize(p, m, c, pl))
    sites["k11_table0"] = lambda g=grid: sparse_conv.build_table(g)
    for i, (kernel, stride, padding, capacity) in enumerate(STRIDED_CONVS):
        out_shape = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                          zip(grid.shape, padding, kernel, stride))
        args = (grid, kernel, stride, padding, out_shape, capacity)
        site = "conv_out" if i == len(STRIDED_CONVS) - 1 else f"down{i}"
        sites[f"k11_{site}"] = (
            lambda a=args: sparse_conv.downsample_with_table(*a))
        co, mo, _, _ = sparse_conv.downsample_with_table(*args)
        grid = SparseGrid(co, mo, out_shape, grid.batch)
    return sites


def _flat(out):
    """The tensors of a site's outputs, the tables' fields too; a map on the
    live ranks is what the tables promise, but both sides here are kernels,
    so the whole map is compared."""
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return []


def main() -> int:
    if not torch.cuda.is_available():
        print("bitmap_study: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = _build_all()
    library, tile = _build.lib(), _build.BITMAP_TILE_WORDS
    points = synthetic_batch(np.random.RandomState(0),
                             device="cuda")["points"][0]
    batch = _rc_batch()
    clouds = {
        "lidar": (points, torch.ones(points.shape[0], dtype=torch.bool,
                                     device="cuda"),
                  (VOXEL_SIZE, PC_RANGE, VOXEL_GRID, CAPACITIES[0], 10)),
        "radar": (batch["radar"][0], batch["radar_mask"][0],
                  (RADAR_LAYER["voxel_size"], RADAR_LAYER["point_cloud_range"],
                   RADAR_GRID, RADAR_LAYER["max_voxels"][1],
                   RADAR_LAYER["max_num_points"]))}
    del batch
    grid = res0_grid(points)[1]
    want, rows = {}, []
    try:
        for rnd, order in enumerate((list(VARIANTS), list(VARIANTS)[::-1])):
            for name in order:
                _use(libs[name], VARIANTS[name][1])
                row = dict(variant=name, round=rnd)
                for site, run in _sites(name, clouds, grid).items():
                    got = _flat(run())
                    if name == "kernel":
                        want.setdefault(site, got)
                    elif not all(torch.equal(g, w)
                                 for g, w in zip(got, want[site])):
                        raise AssertionError(f"{name} {site}: differs from "
                                             f"the library kernel")
                    kernels = device_by_kernel(run, 10)
                    row[site] = sum(kernels.values())
                    row[f"{site}_scan"] = sum(v for k, v in kernels.items()
                                              if "scan_tiles" in k)
                row["k11_sum"] = sum(v for k, v in row.items()
                                     if k.startswith("k11_")
                                     and not k.endswith("_scan"))
                rows.append(row)
                print(f"  {name} (round {rnd}): "
                      + ", ".join(f"{k} {v:.4f}" for k, v in row.items()
                                  if isinstance(v, float)), flush=True)
    finally:
        _use(library, tile)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "bitmap_study.json"),
              "w") as f:
        json.dump(dict(gpu=smi, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
