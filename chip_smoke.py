#!/usr/bin/env python3
"""Smoke run of the PyTorch port (unibev_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare   # phases 5-6, 9-10, 13-15, 18-19 alone

Builds the hand-written CUDA kernels from unibev_tpu_torch/csrc with nvcc,
then, each phase printing one line (or a few) and raising on any failure:

  1. the card (nvidia-smi name and power limit), torch / CUDA versions, the
     kernel build time, and what ``nvcc -Xptxas -v`` reports for K1, K2
     (dcn_fwd), the im2col, K3, K4, K6, K7, K8 and K9 (registers, static
     shared memory, stack, spills);
  2. kernel K1 (MSDA) against its plain PyTorch version at the five
     flagship call shapes, in f32 (TF32 off) and bf16, with both times,
     their ratio and the access width each site takes;
  3. kernel K2 (dcn_fwd, the fused DCNv2 forward) against its plain version
     at the stage-3 and stage-4 shapes, f32 (TF32 off) and bf16, with its
     launch plan per site, its time beside the route it replaced (the
     im2col kernel + torch.matmul) and the plain version's, all three
     summed over the 26 launches of a forward (CUDA events, and the
     profiler's device time for dcn_fwd and the route), its time with mask
     0 (no corner is read; the blend, the product and the loop remain) and
     dcn_fwd's and the route's with offsets an eighth the size; and the
     im2col kernel, which the DCN backward keeps, against its plain
     version, with its launch plan per site, its time (CUDA events and the
     profiler's device time) and with mask 0 (no corner is read), its
     bound beside a second floor (its corner reads from L2, printed and
     not part of the bound), and the backward's column route for d_weight
     (the im2col and cols^T g, a torch.matmul) beside dcn_fwd, which
     samples the same columns;
  4. the tiny camera-only model: CUDA with the kernels against the CPU with
     the plain versions, same weights and inputs;
  5. full-width flagship camera-only predict in bf16 (6 cameras at
     928x1600): launch counts of one forward (12 K1, 26 K2), ms per
     sample (median of 10
     synchronized iterations after 3 warm-ups), peak memory, SCA overflow,
     finite boxes;
  6. a torch.profiler breakdown of one forward by kernel;
  7. the backward kernels against their plain versions (autograd through
     the plain forwards) at the flagship call sites, f32 (TF32 off) and
     bf16, with both times and each site's launch plan: K3 msda_bwd and K4
     dcn_bwd (one launch a call, d_value / d_x added into their tables),
     and K5 scatter_add_rows, which no path launches, alone on 128 MB of
     bf16 contribution rows per site, with index_add_ beside it and K5 on
     the same rows all zero (read, no atomic issued);
  8. one tiny camera-only train step on CUDA against the same step on the
     CPU: losses, gradients and the parameters after the step;
  9. the full-width flagship camera-only train step (float32 parameters,
     bf16 autocast, GridMask and dropout on, AdamW): launch counts of one
     step against the counts derived from the call sites, s/step (median of
     10 after 3 warm-ups), peak memory, finite losses and grad norm, SCA
     overflow, frozen parameters bit-identical after the steps;
 10. a torch.profiler breakdown of one train step by kernel;
 11. the voxelizer's time on the synthetic batch's 300k points; the device
     time of the compact tables of one forward (build_table and the four
     downsample_with_table calls: the active sets of the strided convs);
     and the sparse-conv kernels against their plain versions at every
     flagship LiDAR site, on the active sets and rulebooks of the voxelized
     synthetic batch: K6 sparse_nbr exactly (its time beside K6_BEFORE_MS,
     the kernel over a dense int32 table), K7 sparse_conv in f32 (TF32 off)
     and bf16, with both times and their ratio;
 12. the tiny LC model in LC and L mode: CUDA with the kernels against the
     CPU with the plain versions, same weights and inputs;
 13. full-width flagship LC predict in bf16 (6 cameras at 928x1600 and 300k
     points): launch counts of one forward (18 K1, 26 K2, 8 K6, 21 K7, no
     im2col), ms
     per sample (median of 10 after 3 warm-ups), peak memory, SCA overflow,
     finite boxes, and, printed, the voxels before the cap and each strided
     conv's overflow;
 14. L predict on the same model (the batch without images): launch counts
     (12 K1, 0 K2, 8 K6, 21 K7) and ms per sample;
 15. torch.profiler breakdowns of one LC and one L forward by kernel, and
     the host's time in each (the traced wall less the time spent waiting
     in CUDA synchronizing calls);
 16. the sparse conv's backward against its plain versions at every
     flagship LiDAR site: K8 sparse_inv_nbr exactly at its 4 sites (beside
     K8_BEFORE_MS), K9
     sparse_conv_wgrad at its 21 (f32 with TF32 off, and bf16; the 4
     submanifold convs of a resolution share a rulebook and take fresh
     data each; bf16 on the tensor cores, its time per site and over the
     step beside the plain version's, the bound and K9's time before its
     tensor-core design, K9_BEFORE_MS), and
     SparseConvFn's d_feats (K7 with the transposed weights, over the
     rulebook or K8's inverse one) against autograd through the plain
     forward, with the times of kernels and plain versions and their ratio;
 17. one tiny LC train step on CUDA against the same step on the CPU, the
     LiDAR modules in train mode (batch statistics, sparse backward) and the
     rest in eval mode, so that nothing draws: losses, gradients, updates
     and the LiDAR running statistics;
 18. the full-width flagship LC train step (float32 parameters, bf16
     autocast, modality dropout, GridMask and dropout on): launch counts of
     one step against the counts derived from the call sites (K6 8, K7 41,
     K8 4, K9 21 and K1-K4 with the LiDAR MSDA sites), s/step (median of 10
     after 3 warm-ups) with the flags each step drew, peak memory, finite
     losses, SCA overflow on the camera-live steps, frozen parameters
     bit-identical, LiDAR running statistics moved;
 19. a torch.profiler breakdown of one LC train step by kernel;
 20. K1 and K3 against their plain versions at the cat_128 config's sites
     with 8 heads of D = 16 channels (both encoders' TSA, the dense camera
     SCA over all 6 x 40,000 queries, the LiDAR SCA), f32 (TF32 off) and
     bf16, with K1's access width, K3's launch plan, both times and the
     bound per site;
 21. the tiny LC model with avg fusion, cat fusion (the decoder at twice the
     width) and dual queries: CUDA with the kernels against the CPU with the
     plain versions, same weights: predict, and the losses and every
     gradient of one forward with the LiDAR modules in train mode;
 22. full-width LC predict of the avg_256, dual-queries and cat_128 configs,
     each built from its file with ``build_model_from_config`` (cat_128 in
     float32 with the dense camera SCA): launch counts (as phase 13), ms per
     sample (median of 3 after 1 warm-up), peak memory, SCA overflow 0,
     finite boxes and a profile of one forward; on the avg model also L and
     C predict; cat_128 LC once more with cuDNN's TF32 on;
 23. one full-width LC train step of cat_128 built from its file (float32,
     no autocast, modality dropout): launch counts (as phase 18), s/step
     (median of 2 after 1 warm-up), peak memory, finite losses, grad norm;
 24. the port's train CLI in process (``train_UniBEV.main``) on the
     flagship config file with --synthetic-data for 4 steps (full width,
     B=1, bf16, modality dropout, the config's 2 loader workers): 4 finite
     losses in metrics.jsonl, a checkpoint, SCA overflow 0 on the
     camera-live steps, launches 4 x phase 18's; s/step (median of steps
     2-4), the loader's wait and the host-to-device copy per step, peak
     memory, the idle share that phase 19's device time gives, and the
     loader's own rate (12 batches, 2 workers, no training);
 25. the port's test CLI in process (``test_UniBEV.run``) on that
     checkpoint with --synthetic-data for 4 samples: the flagship config
     (4 results in the JAX schema, launches 4 x phase 13's, SCA overflow 0)
     and the L-only inference config (the camera keys dropped by
     load_params, launches 4 x phase 14's, SCA overflow -1); ms/sample
     through the CLI beside phases 13 and 14;
 26. both CLIs on a nuScenes-shaped tree written to disk (3 samples: six
     1600x900 JPEGs decoded by PIL and a 34,000-point sweep each, info
     pickles) through the flagship config's own pipelines: 2 train steps
     (launches 2 x phase 18's, finite losses, the loader's wait), the
     train loader alone on those files for 2 epochs, then the test CLI on
     2 val samples with the nuScenes metric (launches 2 x phase 13's, SCA
     overflow 0, a finite mAP).

Each kernel's entry in the line before the last gives its launches on the
path it serves (K1, K2, K6, K7: one LC predict; the im2col, K3, K4, K8,
K9: one LC train step; K5, on no path, 0), its time summed over that path's
call sites (CUDA events; K5 over the row chunks of SCATTER_SITES; K1 and K3
also ``d16_*``, summed over cat_128's D = 16 launches), its plain
version's, the least time the card could take for the same work
(``bound_ms``: the larger of the bytes each call must move over 3.35 TB/s
and its operations over 989 TFLOP/s, the H100 SXM's HBM3 and dense bf16
peaks, counting the rulebook entries this run's data holds), and the time
of one PyTorch call computing the same function where there is one
(``library_ms``, K5's float32 ``index_add_``; the port never calls it).
The last line is {"ok": true, "device": {...}}.  The numbers also go to
chip_smoke.json in the output directory beside this script.  Exits non-zero
without a CUDA device or when any phase fails.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from unibev_tpu_torch.flagship import (PC_RANGE,  # noqa: E402
                                       VOXEL_SIZE, build_flagship,
                                       build_model, build_model_from_config,
                                       synthetic_batch, tiny_batch,
                                       tiny_model_cfg)
from unibev_tpu_torch.ops import _build  # noqa: E402
from unibev_tpu_torch.ops.deform_conv import (  # noqa: E402
    deform_im2col, deform_im2col_backward, deform_im2col_reference,
    modulated_deform_conv2d_reference, tap_interior)
from unibev_tpu_torch.ops.msda import (cell_interior,  # noqa: E402
                                       ms_deform_attn, ms_deform_attn_backward,
                                       ms_deform_attn_reference)
from unibev_tpu_torch.ops.scatter import (scatter_add_rows,  # noqa: E402
                                          scatter_add_rows_reference)
from unibev_tpu_torch.ops.sparse_conv import (  # noqa: E402
    SparseGrid, build_table, downsample_with_table, gather_conv, sparse_conv,
    sparse_conv_reference, sparse_conv_wgrad, sparse_conv_wgrad_reference,
    sparse_inv_nbr, sparse_inv_nbr_reference, sparse_nbr, sparse_nbr_reference,
    tap_transpose)
from unibev_tpu_torch.ops.voxelize import voxelize_and_encode  # noqa: E402
from unibev_tpu_torch.parallel.train_state import (make_optimizer,  # noqa: E402
                                                   train_step)

# Relative tolerances, on max |ref| (at least 1).  f32: kernel and plain
# version sum the same terms in another order.  bf16: outputs are rounded to
# bf16 (relative 2^-8), and the DCN product sums 9 * Cin rounded columns.
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}
TINY_REL_TOL = 1e-3     # CPU vs CUDA through a depth-50 backbone, f32, TF32 off
# Backwards: the same relative tolerances.  f32: float32 atomics sum the
# d_value / d_x terms in no fixed order.  bf16: the inputs are bf16 and the
# outputs rounded to bf16.  K5 alone: 1e-5 (atomic order).
# d_loc and d_offset jump across cell edges, where the kernels and
# grid_sample may round a position to different sides; they are compared at
# points 1e-3 pixels or more inside a cell (cell_interior / tap_interior).
BWD_REL_TOL = REL_TOL
SCATTER_REL_TOL = 1e-5
# K9 sums its row spans with float32 atomics in no fixed order: f32 1e-4;
# bf16 inputs 2^-6 (the products are exact in float32 either way).
WGRAD_REL_TOL = REL_TOL
# K9's bf16 time a call at each site before its tensor-core design (the
# CUDA-core kernel; CUDA events on an NVIDIA H100 80GB HBM3 at 700.00 W, as
# PERF.md section 6 records it): phase 16 prints each site's new time
# beside it, and the sum over an LC step's 21 launches (10.702 ms).
K9_BEFORE_MS = {"conv_input": 0.151, "subm0": 0.152, "down0": 0.302,
                "subm1": 0.333, "down1": 0.223, "subm2": 0.324,
                "down2": 0.539, "subm3": 1.533, "conv_out": 0.118}
K9_BEFORE_STEP_MS = 10.702
# K6's and K8's time a call at each site over the dense int32 table, before
# the compact table (CUDA events on an NVIDIA H100 80GB HBM3 at 700.00 W;
# PERF.md section 6 records their sums, 0.288 and 0.164 ms): phases 11 and
# 16 print each site's new time beside it.
K6_BEFORE_MS = {"subm0": 0.0384, "down0": 0.0272, "subm1": 0.0276,
                "down1": 0.0271, "subm2": 0.0471, "down2": 0.0317,
                "subm3": 0.0602, "conv_out": 0.0286}
K8_BEFORE_MS = {"down0": 0.0380, "down1": 0.0414, "down2": 0.0398,
                "conv_out": 0.0444}

# The least time of a call: the larger of its bytes (each input read once,
# each output written once) over the H100 SXM's HBM3 rate and its
# operations over the H100 SXM's dense bf16 tensor-core peak; the card's
# name and power limit are printed beside every number.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
# A second floor of the im2col, printed beside its bound and not part of
# it: its four corner reads per column vector from L2 at ~7 TB/s, an
# estimate of the H100's L2 read rate (NVIDIA publishes none)
L2_BYTES_PER_S = 7e12
# the im2col's sums over its sites besides add_site's
IM2COL_SUMS = ("device_ms", "no_loads_ms", "no_loads_device_ms", "l2_ms",
               "wgrad_route_ms", "wgrad_route_device_ms")

# (name, calls per flagship forward, B, V, Q, heads, D, levels, points):
# the camera-only path's sites (forward and train step), then the LiDAR
# encoder's, which LC adds
MSDA_SITES = [
    ("tsa", 3, 1, 40000, 40000, 8, 32, ((200, 200),), 4),
    ("camera_sca", 3, 6, 1450, 10240, 8, 32, ((29, 50),), 8),
    ("decoder_ca", 6, 1, 40000, 900, 8, 32, ((200, 200),), 4),
]
LIDAR_MSDA_SITES = [
    ("pts_tsa", 3, 1, 40000, 40000, 8, 32, ((200, 200),), 4),
    ("pts_sca", 3, 1, 32400, 40000, 8, 32, ((180, 180),), 8),
]
# The cat_128 config's sites where its 128-wide encoders run K1 and K3 at
# D = 16 (8 heads x 16 channels): both encoders' TSA, the dense camera SCA
# (every one of the 40,000 queries of each camera: the file sets no
# rebatch_k) and the LiDAR SCA.  Its decoder runs at 256 channels, D = 32:
# the flagship's decoder_ca shape, held in phases 2 and 7.
CAT_MSDA_SITES = [
    ("cat_tsa", 6, 1, 40000, 40000, 8, 16, ((200, 200),), 4),
    ("cat_camera_sca", 3, 6, 1450, 40000, 8, 16, ((29, 50),), 8),
    ("cat_pts_sca", 3, 1, 32400, 40000, 8, 16, ((180, 180),), 8),
]
# The configurations phases 22 and 23 build from their files
CONFIGS = {name: os.path.join(ROOT, "configs", "unibev", f"unibev_nus_LC_{name}"
                              "_modality_dropout.py")
           for name in ("avg_256", "cnw_dual_queries", "cat_128")}
# the tiny LC model's fusion variants (phase 21)
TINY_VARIANTS = {"avg": dict(fusion="avg", feature_norm=None),
                 "cat": dict(fusion="cat", feature_norm=None),
                 "dual_queries": dict(dual_queries=True)}

# The flagship phases hold the launch counts to expected_*_launches; off in
# --compare, which also runs other checkouts' packages.
CHECK_LAUNCHES = True

# (name, calls per flagship forward, B, H, W, Cin, Cout)
DCN_SITES = [
    ("stage3", 23, 6, 58, 100, 256, 256),
    ("stage4", 3, 6, 29, 50, 512, 512),
]

# K5 at the shapes of the contribution rows of each MSDA and DCN site, cut
# into launches of at most 128 MB of bf16 rows as the JAX package chunks its
# MSDA backward: (site, launches per LC train step, rows a launch, row
# width, table rows).  K3 and K4 add into their tables themselves and no
# path launches K5; its record sums these launches.
SCATTER_SITES = [
    ("tsa", 9, 1706752, 32, 320000),
    ("camera_sca", 24, 1966080, 32, 69600),
    ("decoder_ca", 6, 115200, 32, 320000),
    ("pts_tsa", 9, 1706752, 32, 320000),
    ("pts_sca", 18, 1706752, 32, 259200),
    ("stage3", 138, 208800, 256, 34800),
    ("stage4", 9, 104400, 512, 8700),
]


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` in ms over ``iters`` launches, warmed up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """Device time per call of ``fn`` in ms: the profiler's kernel time over
    ``iters`` calls, warmed up (unlike ``cuda_ms``, never the host's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1000 / iters


def new_rec():
    """A kernel's record: times summed over its call sites (calls x ms per
    call), worst error, the least times, and the sites."""
    return dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, bound_ms=0.0,
                bytes_ms=0.0, ops_ms=0.0, sites={})


def add_site(rec, site, calls, ms, plain, err, nbytes, ops, **extra):
    """Add one call site (``calls`` launches per path, ``ms`` / ``plain``
    per call) with its bytes and operations to ``rec``; returns the site's
    least time per call in ms."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    rec["sites"][site] = dict(ms=ms, plain_ms=plain, calls=calls, err=err,
                              bytes=nbytes, ops=ops, bound_ms=bound, **extra)
    for k, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound),
                 ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
        rec[k] += calls * v
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return bound


def kernel_entry(name, source, replaces, launches, rec, library_ms=None):
    """One entry of the ``kernels`` line."""
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=rec["max_abs_err"],
                ms=rec["ms"], plain_ms=rec["plain_ms"],
                bound_ms=rec["bound_ms"],
                bound_by="bytes" if rec["bytes_ms"] >= rec["ops_ms"]
                else "operations", library_ms=library_ms)


def ratio_line(label, rec):
    """The summed kernel and plain times of ``rec`` and their ratio, both
    measured in this run."""
    print(f"  {label}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
          f"ms, kernel/plain {rec['ms'] / rec['plain_ms']:.4f}, bound "
          f"{rec['bound_ms']:.4f} ms", flush=True)


def ptxas_report(kernels=("msda_fwd", "dcn_fwd", "dcn_im2col", "msda_bwd",
                          "dcn_bwd", "sparse_nbr", "sparse_conv_kernel",
                          "sparse_inv_nbr", "sparse_wgrad")):
    """What ``nvcc -Xptxas -v`` printed (build/kernels/nvcc.log) for the
    entry functions whose names hold one of ``kernels``: one dict each."""
    log = _build.BUILD_DIR / "nvcc.log"
    found, cur = [], None
    for line in log.read_text().splitlines() if log.exists() else []:
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = dict(name=name) if any(k in name for k in kernels) else None
            if cur is not None:
                found.append(cur)
        elif cur is not None and "stack frame" in line:
            cur["frame"] = line.strip()
        elif cur is not None and "Used" in line and "registers" in line:
            cur["used"] = line.split(":", 1)[1].strip()
            cur = None
    names = [f["name"] for f in found]
    filt = shutil.which("c++filt")
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names), text=True,
                             capture_output=True).stdout.splitlines()
        for f, n in zip(found, out):
            f["name"] = n
    return found


def check(name, got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    tol = rel * max(1.0, want.float().abs().max().item())
    line = f"  {name}: max_abs_err {err:.3e} tol {tol:.3e}"
    print(line, flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > tol {tol}")
    return err


def _plain_backward(fn, inputs, grad):
    """A closure that runs only the backward of ``fn`` through autograd (the
    plain versions' gradient), on a graph built once."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)


def _msda_inputs(gen, B, V, Q, heads, D, levels, P, dtype):
    L = len(levels)
    value = torch.randn(B, V, heads, D, device="cuda", generator=gen).to(dtype)
    loc = torch.rand(B, Q, heads, L, P, 2, device="cuda", generator=gen) * 1.2 - 0.1
    attn = torch.softmax(torch.randn(B, Q, heads, L * P, device="cuda",
                                     generator=gen), -1)
    return value, loc, attn.view(B, Q, heads, L, P).to(dtype)


def _dcn_inputs(gen, B, H, W, Cin, dtype):
    x = torch.randn(B, H, W, Cin, device="cuda", generator=gen).to(dtype)
    off = (torch.randn(B, H, W, 18, device="cuda", generator=gen) * 2).to(dtype)
    mask = torch.rand(B, H, W, 9, device="cuda", generator=gen).to(dtype)
    return x, off, mask


def phase_msda(gen):
    # imported here: --compare also runs against checkouts that predate it
    from unibev_tpu_torch.ops.msda import msda_fwd_route
    print("phase 2: K1 msda_fwd vs ms_deform_attn_reference", flush=True)
    rec = new_rec()
    for name, calls, B, V, Q, heads, D, levels, P in MSDA_SITES + LIDAR_MSDA_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, attn = _msda_inputs(gen, B, V, Q, heads, D, levels, P,
                                            dtype)
            got = ms_deform_attn(value, levels, loc, attn)
            want = ms_deform_attn_reference(value, levels, loc, attn)
            err = check(f"{name} {str(dtype)[6:]}", got, want, REL_TOL[dtype])
            vec = msda_fwd_route(D, value.element_size(), value.data_ptr())
            print(f"  {name} {str(dtype)[6:]}: K1 {vec}-byte loads",
                  flush=True)
            if dtype is torch.bfloat16:
                ms = cuda_ms(lambda: ms_deform_attn(value, levels, loc, attn), 20)
                plain = cuda_ms(lambda: ms_deform_attn_reference(value, levels, loc, attn), 5)
                # value (the whole map, or the four D-wide corner rows of
                # every point where those are fewer bytes), loc (f32), attn,
                # out; 4 corners x D FMAs per point
                pts = B * Q * heads * len(levels) * P
                gathered = min(2 * B * V * heads * D, 4 * pts * 2 * D)
                bound = add_site(rec, name, calls, ms, plain, err,
                                 gathered + 10 * pts + 2 * B * Q * heads * D,
                                 8 * D * pts, vec_bytes=vec)
                print(f"  {name} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                      f"kernel/plain {ms / plain:.4f}, bound {bound:.4f} ms "
                      f"(x{calls} per forward)", flush=True)
    ratio_line("K1 over the 18 launches of one LC forward", rec)
    return rec


def phase_dcn(gen):
    # imported here: --compare also runs against checkouts that predate it
    from unibev_tpu_torch.ops.deform_conv import (dcn_fwd, dcn_fwd_plan,
                                                  im2col_plan)
    print("phase 3: K2 dcn_fwd (the fused DCN forward) vs "
          "modulated_deform_conv2d_reference and the route it replaced "
          "(im2col + torch.matmul); the im2col (the backward's columns) vs "
          "deform_im2col_reference", flush=True)
    fwd, cols_rec = new_rec(), new_rec()
    for k in ("route_ms", "device_ms", "route_device_ms", "no_loads_ms",
              "small_ms", "small_route_ms"):
        fwd[k] = 0.0
    for k in IM2COL_SUMS:
        cols_rec[k] = 0.0
    for name, calls, B, H, W, Cin, Cout in DCN_SITES:
        plan = dcn_fwd_plan(Cin, Cout)
        print(f"  {name}: dcn_fwd plan {plan._asdict()}", flush=True)
        for dtype in (torch.float32, torch.bfloat16):
            x, off, mask = _dcn_inputs(gen, B, H, W, Cin, dtype)
            # (9 Cin, Cout), held transposed as DeformConv2d holds it
            w = (torch.randn(Cout, 9 * Cin, device="cuda", generator=gen)
                 * (9 * Cin) ** -0.5).to(dtype).t()
            tag = f"{name} {str(dtype)[6:]}"
            err = check(tag + " dcn_fwd", dcn_fwd(x, off, mask, w),
                        modulated_deform_conv2d_reference(x, off, mask, w),
                        REL_TOL[dtype])
            err_cols = check(tag + " im2col", deform_im2col(x, off, mask),
                             deform_im2col_reference(x, off, mask),
                             REL_TOL[dtype])
            if dtype is not torch.bfloat16:
                continue
            ms = cuda_ms(lambda: dcn_fwd(x, off, mask, w), 20)
            route = cuda_ms(lambda: torch.matmul(deform_im2col(x, off, mask), w),
                            20)
            dev = device_ms(lambda: dcn_fwd(x, off, mask, w), 20)
            route_dev = device_ms(
                lambda: torch.matmul(deform_im2col(x, off, mask), w), 20)
            plain = cuda_ms(lambda: modulated_deform_conv2d_reference(
                x, off, mask, w), 5)
            # the same call with mask 0: no corner weighs anything, so none
            # is read; the blend of zeros, the product, the weights' stream
            # and the loop remain
            zero = torch.zeros_like(mask)
            no_loads = cuda_ms(lambda: dcn_fwd(x, off, zero, w), 20)
            cols_ms = cuda_ms(lambda: deform_im2col(x, off, mask), 20)
            plain_cols = cuda_ms(lambda: deform_im2col_reference(x, off, mask), 5)
            # the same call with offsets of 1/8 the size (std 0.25 pixel):
            # neighbouring sample points then share their corners, and the
            # time shows what reuse of the loaded corners is worth
            small = (off.float() / 8).to(dtype)
            check(tag + " dcn_fwd, small offsets", dcn_fwd(x, small, mask, w),
                  modulated_deform_conv2d_reference(x, small, mask, w),
                  REL_TOL[dtype])
            small_ms = cuda_ms(lambda: dcn_fwd(x, small, mask, w), 20)
            small_route = cuda_ms(lambda: torch.matmul(
                deform_im2col(x, small, mask), w), 20)
            pix = B * H * W
            # x, offsets, mask, weight, out; the product and the blend (4
            # corners x Cin FMAs per tap)
            bound = add_site(fwd, name, calls, ms, plain, err,
                             2 * (pix * (Cin + 27 + Cout) + 9 * Cin * Cout),
                             2 * pix * 9 * Cin * Cout + 8 * pix * 9 * Cin,
                             route_ms=route, device_ms=dev,
                             route_device_ms=route_dev, no_loads_ms=no_loads,
                             small_ms=small_ms, small_route_ms=small_route,
                             plan=plan._asdict())
            for k, v in (("route_ms", route), ("device_ms", dev),
                         ("route_device_ms", route_dev),
                         ("no_loads_ms", no_loads),
                         ("small_ms", small_ms),
                         ("small_route_ms", small_route)):
                fwd[k] += calls * v
            # the im2col: its plan, device time, mask 0 (no corner is read;
            # the geometry, the blend of zeros and the column stores
            # remain), and the backward's column route for d_weight (the
            # im2col and cols^T g) beside dcn_fwd, which samples the same
            # columns and multiplies them in one kernel
            cplan = im2col_plan(B, H, W, Cin, H, W, 9, 2, x.data_ptr())
            cols_dev = device_ms(lambda: deform_im2col(x, off, mask), 20)
            cols_zero = cuda_ms(lambda: deform_im2col(x, off, zero), 20)
            cols_zero_dev = device_ms(lambda: deform_im2col(x, off, zero), 20)
            g = torch.randn(pix, Cout, device="cuda", generator=gen).to(dtype)
            wgrad = lambda: torch.matmul(deform_im2col(x, off, mask).t(), g)  # noqa: E731
            wgrad_ms = cuda_ms(wgrad, 20)
            wgrad_dev = device_ms(wgrad, 20)
            # x, offsets, mask, columns; 4 corners x Cin FMAs per tap.  The
            # corners come from L2: four column vectors' bytes per column
            # vector, unless L1 holds them
            l2_bytes = 4 * 2 * pix * 9 * Cin
            l2_ms = l2_bytes / L2_BYTES_PER_S * 1e3
            cbound = add_site(cols_rec, name, calls, cols_ms, plain_cols,
                              err_cols, 2 * pix * (Cin + 27 + 9 * Cin),
                              8 * pix * 9 * Cin, plan=cplan._asdict(),
                              device_ms=cols_dev, no_loads_ms=cols_zero,
                              no_loads_device_ms=cols_zero_dev,
                              l2_bytes=l2_bytes, l2_ms=l2_ms,
                              wgrad_route_ms=wgrad_ms,
                              wgrad_route_device_ms=wgrad_dev,
                              dcn_fwd_ms=ms, dcn_fwd_device_ms=dev)
            for k, v in (("device_ms", cols_dev), ("no_loads_ms", cols_zero),
                         ("no_loads_device_ms", cols_zero_dev),
                         ("l2_ms", l2_ms), ("wgrad_route_ms", wgrad_ms),
                         ("wgrad_route_device_ms", wgrad_dev)):
                cols_rec[k] += calls * v
            print(f"  {name} bf16: im2col plan {cplan._asdict()}; im2col "
                  f"{cols_ms:.4f} ms (device {cols_dev:.4f}), mask 0 "
                  f"{cols_zero:.4f} ms (device {cols_zero_dev:.4f}); bound "
                  f"{cbound:.4f} ms (bytes); L2 corner bytes "
                  f"{l2_bytes / 1e6:.1f} MB, {l2_ms:.4f} ms at "
                  f"{L2_BYTES_PER_S / 1e12:.0f} TB/s; backward column route "
                  f"(im2col + cols^T g) {wgrad_ms:.4f} ms (device "
                  f"{wgrad_dev:.4f}) beside dcn_fwd {ms:.4f} ms (device "
                  f"{dev:.4f})", flush=True)
            print(f"  {name} bf16: dcn_fwd {ms:.4f} ms, route (im2col + "
                  f"matmul) {route:.4f} ms, plain {plain:.4f} ms; dcn_fwd/route "
                  f"{ms / route:.4f}, dcn_fwd/plain {ms / plain:.4f}; device "
                  f"time dcn_fwd {dev:.4f} ms, route {route_dev:.4f} ms "
                  f"({dev / route_dev:.4f}); bound "
                  f"{bound:.4f} ms ({bound / ms:.3f} of dcn_fwd); mask 0 "
                  f"(no corner loads) {no_loads:.4f} ms; "
                  f"im2col {cols_ms:.4f} ms, plain {plain_cols:.4f} ms; "
                  f"offsets / 8: dcn_fwd {small_ms:.4f} ms, route "
                  f"{small_route:.4f} ms (x{calls} per forward)", flush=True)
    print(f"  dcn_fwd over the 26 launches of one forward: {fwd['ms']:.4f} ms, "
          f"route {fwd['route_ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms; "
          f"dcn_fwd/route {fwd['ms'] / fwd['route_ms']:.4f}, dcn_fwd/plain "
          f"{fwd['ms'] / fwd['plain_ms']:.4f}; device time dcn_fwd "
          f"{fwd['device_ms']:.4f} ms, route {fwd['route_device_ms']:.4f} ms "
          f"({fwd['device_ms'] / fwd['route_device_ms']:.4f}); bound "
          f"{fwd['bound_ms']:.4f} ms "
          f"({fwd['bound_ms'] / fwd['ms']:.3f} of dcn_fwd); mask 0 (no "
          f"corner loads) {fwd['no_loads_ms']:.4f} ms; offsets / 8: dcn_fwd "
          f"{fwd['small_ms']:.4f} ms, route "
          f"{fwd['small_route_ms']:.4f} ms", flush=True)
    print(f"  im2col over the 26 launches of a train step: "
          f"{cols_rec['ms']:.4f} ms (device {cols_rec['device_ms']:.4f}), "
          f"plain {cols_rec['plain_ms']:.4f} ms, mask 0 "
          f"{cols_rec['no_loads_ms']:.4f} ms (device "
          f"{cols_rec['no_loads_device_ms']:.4f}); bound "
          f"{cols_rec['bound_ms']:.4f} ms (bytes; "
          f"{cols_rec['bound_ms'] / cols_rec['ms']:.3f} of the kernel), L2 "
          f"corner floor {cols_rec['l2_ms']:.4f} ms; backward column route "
          f"{cols_rec['wgrad_route_ms']:.4f} ms (device "
          f"{cols_rec['wgrad_route_device_ms']:.4f}) beside dcn_fwd "
          f"{fwd['ms']:.4f} ms (device {fwd['device_ms']:.4f})", flush=True)
    return fwd, cols_rec


def phase_tiny():
    print("phase 4: tiny C-only model, CUDA kernels vs CPU plain versions",
          flush=True)
    cpu_model = build_model(tiny_model_cfg(), "cpu", seed=0)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = tiny_batch(np.random.RandomState(0))
    gpu_batch = {k: v.to("cuda") for k, v in batch.items()}
    before = dict(_build.launches)
    with torch.inference_mode():
        want, got = cpu_model(batch), gpu_model(gpu_batch)
    if dict(_build.launches) == before:
        raise AssertionError("the tiny model on CUDA launched no kernel")
    rec = {}
    for k in ("all_cls_scores", "all_bbox_preds"):
        rec[k] = check(k, got[k].cpu(), want[k], TINY_REL_TOL)
    want, got = cpu_model.predict(batch), gpu_model.predict(gpu_batch)
    if not torch.equal(got["labels"].cpu(), want["labels"]):
        raise AssertionError("decoded labels differ between CUDA and CPU")
    for k in ("scores", "bboxes"):
        rec[k] = check("decoded " + k, got[k].cpu(), want[k], TINY_REL_TOL)
    return rec


def phase_flagship(iters=10):
    print("phase 5: full-width flagship camera-only predict, bf16", flush=True)
    model = build_flagship(use_lidar=False, device="cuda", dtype=torch.bfloat16,
                           seed=0)
    batch = synthetic_batch(np.random.RandomState(0), device="cuda")
    for _ in range(3):                                     # warm-up
        model.predict(batch)
    torch.cuda.synchronize()

    for k in list(_build.launches):
        _build.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    out = model.predict(batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.launches.items() if v}
    peak = torch.cuda.max_memory_allocated()

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        model.predict(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000 / batch["img"].shape[0])
    ms = float(np.median(times))

    boxes, scores = out["bboxes"], out["scores"]
    overflow = int(out["sca_overflow"])
    finite = bool(torch.isfinite(boxes).all() and torch.isfinite(scores).all())
    rec = dict(ms_per_sample=ms, ms_min=min(times), ms_max=max(times),
               iters=iters, peak_bytes=peak, launches=launches,
               sca_overflow=overflow, boxes_finite=finite,
               boxes_shape=list(boxes.shape), n_valid=int(out["valid"].sum()))
    print(f"  {ms:.2f} ms/sample (median of {iters}; min {min(times):.2f}, "
          f"max {max(times):.2f}); peak "
          f"{peak / 2 ** 30:.2f} GiB; launches per forward {launches}; "
          f"sca_overflow {overflow}; boxes finite {finite} {tuple(boxes.shape)}",
          flush=True)
    expected = expected_predict_launches(lidar=False)
    if CHECK_LAUNCHES and launches != expected:
        raise AssertionError(f"expected launches {expected}, got {launches}")
    if overflow != 0 or not finite or tuple(boxes.shape) != (1, 300, 9):
        raise AssertionError(f"bad flagship output: {rec}")
    return model, batch, rec


def phase_backward(gen):
    # imported here: --compare also runs against checkouts that predate them
    from unibev_tpu_torch.ops.deform_conv import dcn_bwd_plan
    from unibev_tpu_torch.ops.msda import msda_bwd_plan
    print("phase 7: K3 msda_bwd and K4 dcn_bwd (d_value / d_x added into "
          "their tables) and K5 scatter_add_rows vs plain versions", flush=True)
    recs = {k: new_rec() for k in ("msda_bwd", "dcn_bwd", "scatter_add_rows")}
    recs["scatter_add_rows"]["library_ms"] = 0.0
    for k in ("msda_bwd", "dcn_bwd"):
        recs[k]["device_ms"] = 0.0

    def record(kernel, site, calls, ms, plain, err, nbytes, ops, **extra):
        bound = add_site(recs[kernel], site, calls, ms, plain, err, nbytes, ops,
                         **extra)
        dev = extra.get("device_ms")
        if dev is not None:
            recs[kernel]["device_ms"] += calls * dev
        print(f"  {kernel} {site} bf16: kernel {ms:.4f} ms"
              + ("" if dev is None else f" (device {dev:.4f} ms)")
              + f", plain {plain:.4f} ms, bound {bound:.4f} ms (x{calls} per "
              f"LC train step)", flush=True)

    def one_launch(kernel, fn):
        """``fn()``, which must launch ``kernel`` once and K5 never."""
        before = dict(_build.launches)
        out = fn()
        torch.cuda.synchronize()
        grew = {k: v - before.get(k, 0) for k, v in _build.launches.items()
                if v != before.get(k, 0)}
        if grew != {kernel: 1}:
            raise AssertionError(f"one backward call launched {grew}")
        return out

    for name, calls, B, V, Q, heads, D, levels, P in MSDA_SITES + LIDAR_MSDA_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, attn = _msda_inputs(gen, B, V, Q, heads, D, levels, P,
                                            dtype)
            g = torch.randn(B, Q, heads * D, device="cuda", generator=gen).to(dtype)
            got = one_launch("msda_bwd", lambda: ms_deform_attn_backward(
                value, levels, loc, attn, g))
            plain = _plain_backward(
                lambda v, l, a: ms_deform_attn_reference(v, levels, l, a),
                (value, loc, attn), g)
            interior = cell_interior(loc, levels)
            errs = [check(f"{name} {str(dtype)[6:]} {n}", a * m, b * m,
                          BWD_REL_TOL[dtype])
                    for n, a, b, m in zip(("d_value", "d_loc", "d_attn"), got,
                                          plain(), (1, interior, 1))]
            print(f"  ({int((~interior).sum())} of {interior.numel()} points "
                  f"on a cell edge left out of d_loc)", flush=True)
            if dtype is torch.bfloat16:
                plan = msda_bwd_plan(B, V, Q, heads, D, 2, value.data_ptr(),
                                     g.data_ptr())
                print(f"  {name}: msda_bwd plan {plan._asdict()}", flush=True)
                run = lambda: ms_deform_attn_backward(value, levels, loc, attn, g)  # noqa: E731
                # value, loc, attn, g in; d_value, d_loc, d_attn out; three
                # 4-corner x D products per point
                pts = B * Q * heads * len(levels) * P
                record("msda_bwd", name, calls, cuda_ms(run, 10),
                       cuda_ms(plain, 3), max(errs),
                       4 * B * V * heads * D + 20 * pts + 2 * B * Q * heads * D,
                       24 * D * pts, device_ms=device_ms(run, 5),
                       plan=plan._asdict())
            del plain, got

    for name, calls, B, H, W, Cin, _ in DCN_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            x, off, mask = _dcn_inputs(gen, B, H, W, Cin, dtype)
            d_cols = torch.randn(B * H * W, 9 * Cin, device="cuda",
                                 generator=gen).to(dtype)
            got = one_launch("dcn_bwd", lambda: deform_im2col_backward(
                x, off, mask, d_cols))
            plain = _plain_backward(deform_im2col_reference, (x, off, mask),
                                    d_cols)
            interior = tap_interior(off)
            errs = [check(f"{name} {str(dtype)[6:]} {n}", a * m, b * m,
                          BWD_REL_TOL[dtype])
                    for n, a, b, m in zip(("d_x", "d_offset", "d_mask"), got,
                                          plain(), (1, interior, 1))]
            print(f"  ({int((~interior).sum()) // 2} of {interior.numel() // 2} "
                  f"taps on a cell edge left out of d_offset)", flush=True)
            if dtype is torch.bfloat16:
                plan = dcn_bwd_plan(B, H, W, Cin, H, W, 9, 2, x.data_ptr(),
                                    d_cols.data_ptr())
                print(f"  {name}: dcn_bwd plan {plan._asdict()}", flush=True)
                run = lambda: deform_im2col_backward(x, off, mask, d_cols)  # noqa: E731
                # x, offsets, mask, d_cols in; d_x, d_offset, d_mask out
                pix = B * H * W
                record("dcn_bwd", name, calls, cuda_ms(run, 10),
                       cuda_ms(plain, 3), max(errs),
                       2 * pix * (2 * Cin + 54 + 9 * Cin), 24 * pix * 9 * Cin,
                       device_ms=device_ms(run, 5), plan=plan._asdict())
            del plain, got

    for site, calls, M, L, tr in SCATTER_SITES:
        idx = torch.randint(0, tr, (M,), device="cuda", generator=gen,
                            dtype=torch.int32)
        contrib = torch.randn(M, L, device="cuda", generator=gen).bfloat16()
        err = check(f"{site} scatter", scatter_add_rows(idx, contrib, tr),
                    scatter_add_rows_reference(idx, contrib, tr),
                    SCATTER_REL_TOL)
        # the library call: index_add_ into a float32 table, its inputs
        # converted beforehand
        table = torch.zeros(tr, L, device="cuda")
        idx64, contrib32 = idx.long(), contrib.float()
        lib = cuda_ms(lambda: table.index_add_(0, idx64, contrib32), 20)
        recs["scatter_add_rows"]["library_ms"] += calls * lib
        # the same rows, all zero: K5 reads them and issues no atomic
        zero = torch.zeros_like(contrib)
        zero_ms = cuda_ms(lambda: scatter_add_rows(idx, zero, tr), 20)
        recs["scatter_add_rows"]["zero_rows_ms"] = (
            recs["scatter_add_rows"].get("zero_rows_ms", 0.0) + calls * zero_ms)
        record("scatter_add_rows", site, calls,
               cuda_ms(lambda: scatter_add_rows(idx, contrib, tr), 20),
               cuda_ms(lambda: scatter_add_rows_reference(idx, contrib, tr), 5),
               err, 4 * M + 2 * M * L + 4 * tr * L, M * L, library_ms=lib,
               zero_rows_ms=zero_ms)
        print(f"  index_add_ {site}: {lib:.4f} ms; K5 on all-zero rows "
              f"{zero_ms:.4f} ms", flush=True)
        del idx, contrib, zero, table, idx64, contrib32
    for k in ("msda_bwd", "dcn_bwd"):
        ratio_line(f"{k} over the launches of one LC train step", recs[k])
        print(f"  {k} device time over the launches of one LC train step: "
              f"{recs[k]['device_ms']:.4f} ms", flush=True)
    ratio_line("scatter_add_rows over SCATTER_SITES", recs["scatter_add_rows"])
    print(f"  scatter_add_rows on all-zero rows over SCATTER_SITES: "
          f"{recs['scatter_add_rows']['zero_rows_ms']:.4f} ms", flush=True)
    torch.cuda.empty_cache()
    return recs


def _sparse_launches():
    """The sparse encoder per forward: (K6 rulebooks, one per resolution and
    per strided conv; K7 convs; strided convs)."""
    last = len(ENCODER_CHANNELS) - 1
    subm = sum(2 * (len(c) - 1 if i < last else len(c))
               for i, c in enumerate(ENCODER_CHANNELS))
    strided = len(DOWN_PADDINGS) + 1                    # and conv_out
    convs = 1 + subm + strided                          # and conv_input
    return len(ENCODER_CHANNELS) + strided, convs, strided


def expected_predict_launches(camera=True, lidar=True):
    """Kernel launches of one flagship predict, LC, C (``lidar`` False) or
    L (``camera`` False), from the call sites: K1 once per MSDA call (the
    decoder's, the camera encoder's and the LiDAR encoder's), K2
    (dcn_fwd) once per DCN call, and the sparse encoder's K6 and K7.  No
    im2col: only the DCN backward builds columns."""
    sites = [s for s in MSDA_SITES if camera or s[0] == "decoder_ca"]
    sites += LIDAR_MSDA_SITES if lidar else []
    out = dict(msda_fwd=sum(s[1] for s in sites))
    if camera:
        out["dcn_fwd"] = sum(s[1] for s in DCN_SITES)
    if lidar:
        nbr, convs, _ = _sparse_launches()
        out.update(sparse_nbr=nbr, sparse_conv=convs)
    return out


def expected_train_launches(lidar=False):
    """Kernel launches of one flagship train step, C or (``lidar``) LC, from
    the call sites: K1 and K3 once per MSDA call; K2 (dcn_fwd) once per DCN
    call and once more in the backbone's checkpoint recompute; the im2col
    (the columns for d_weight) and K4 once per DCN backward; no K5 (K3 and
    K4 add into their tables themselves).  LC adds the LiDAR encoder's MSDA
    sites and the sparse encoder: one K6 rulebook per resolution and per
    strided conv, K7 once per conv forward and once per conv but conv_input
    backward (d_feats; the voxel features need none), K8 once per strided
    conv, K9 once per conv."""
    sites = MSDA_SITES + (LIDAR_MSDA_SITES if lidar else [])
    msda = sum(s[1] for s in sites)
    dcn = sum(s[1] for s in DCN_SITES)
    out = dict(msda_fwd=msda, msda_bwd=msda, dcn_fwd=2 * dcn, dcn_im2col=dcn,
               dcn_bwd=dcn)
    if lidar:
        nbr, convs, strided = _sparse_launches()
        out.update(sparse_nbr=nbr, sparse_conv=2 * convs - 1,
                   sparse_inv_nbr=strided, sparse_conv_wgrad=convs)
    return out


def check_each(prefix, got, want, rel, floor=1e-12):
    """Relative check per tensor, on each tensor's own max |want| (at least
    ``floor``)."""
    worst = 0.0
    for name, w in want.items():
        gv, wv = got[name].detach().float().cpu(), w.detach().float()
        err = (gv - wv).abs().max().item()
        scale = max(wv.abs().max().item(), floor)
        if not err <= rel * scale:
            raise AssertionError(f"{prefix} {name}: max_abs_err {err} > tol "
                                 f"{rel * scale}")
        worst = max(worst, err / scale)
    print(f"  {prefix}: {len(want)} tensors, worst relative error {worst:.3e} "
          f"(tol {rel})", flush=True)
    return worst


# The LiDAR branch's modules: their BatchNorms use batch statistics in train
# mode and update their running statistics.
LIDAR_MODULES = ("pts_middle_encoder", "pts_backbone", "pts_neck")


def lidar_running_stats(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.startswith(LIDAR_MODULES) and n.endswith(("running_mean",
                                                             "running_var"))}


def phase_tiny_train(lidar=False):
    if lidar:
        print("phase 17: tiny LC train step, CUDA kernels vs CPU plain "
              "versions, the LiDAR modules in train mode", flush=True)
    else:
        print("phase 8: tiny C-only train step, CUDA kernels vs CPU plain "
              "versions", flush=True)
    cpu_model = build_model(tiny_model_cfg(use_lidar=lidar), "cpu", seed=0,
                            train=True).eval()
    for name in LIDAR_MODULES if lidar else ():
        getattr(cpu_model, name).train()       # batch statistics; no draws
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    start = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    stats0 = lidar_running_stats(cpu_model)
    batch = tiny_batch(np.random.RandomState(0))
    gpu_batch = {k: v.to("cuda") for k, v in batch.items()}
    metrics = []
    for model, b in ((cpu_model, batch), (gpu_model, gpu_batch)):
        opt, sched = make_optimizer(model)
        before = dict(_build.launches)
        metrics.append(train_step(model, opt, sched, b))
        torch.cuda.synchronize()
    launched = {k for k, v in _build.launches.items() if v > before.get(k, 0)}
    need = {"msda_bwd", "dcn_bwd"}
    if lidar:
        need |= {"sparse_nbr", "sparse_conv", "sparse_inv_nbr",
                 "sparse_conv_wgrad"}
    if not need <= launched:
        raise AssertionError(f"the tiny CUDA step launched only {launched}")
    cpu_p = dict(cpu_model.named_parameters())
    gpu_p = {n: p.detach().cpu() for n, p in gpu_model.named_parameters()}
    grads = {n: p.grad for n, p in cpu_p.items() if p.grad is not None}
    rec = dict(
        losses=check_each("losses", metrics[1], metrics[0], TINY_REL_TOL),
        grads=check_each("gradients", {n: gpu_model.get_parameter(n).grad
                                       for n in grads}, grads, TINY_REL_TOL))
    if lidar:
        want = lidar_running_stats(cpu_model)
        if any(torch.equal(want[n], stats0[n]) for n in want):
            raise AssertionError("a LiDAR running statistic did not move")
        rec["running_stats"] = check_each(
            "LiDAR running statistics", lidar_running_stats(gpu_model), want,
            TINY_REL_TOL)
    want, sure = {}, {}
    for n, g in grads.items():
        want[n] = cpu_p[n].detach() - start[n]
        # Adam's first update is about lr * sign(grad) (+ the decay): compare
        # it where the gradient check fixes the sign (|grad| above its own
        # tolerance) and eps does not blur it (|grad| > 1e3 eps), and where
        # both gradients are exactly 0 (decay only); a gradient that is zero
        # up to rounding (the key bias of an attention, a sum of cancelling
        # atomics) takes either sign
        g, g_gpu = g.abs(), gpu_model.get_parameter(n).grad.cpu()
        sure[n] = (((g > TINY_REL_TOL * g.max()) & (g > 1e-5))
                   | ((g == 0) & (g_gpu == 0)))

    def update_err(after):
        """(worst error, its tensor) of the update ``after - start`` on the
        sure elements, less one float32 spacing of the result (each device
        rounds p + update to float32), relative to each tensor's largest CPU
        update (about its lr)."""
        worst = (0.0, None)
        for n, w in want.items():
            m = sure[n]
            if m.any():
                a = torch.maximum(after[n][m].abs(), cpu_p[n].detach()[m].abs())
                ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
                err = ((after[n] - start[n] - w)[m].abs() - ulp).clamp_min(0)
                rel = err.max().item() / w[m].abs().max().clamp_min(1e-30).item()
                worst = max(worst, (rel, n), key=lambda t: t[0])
        return worst

    rec["updates"], where = update_err(gpu_p)
    rec["updates_compared"] = sum(int(m.sum()) for m in sure.values())
    rec["updates_total"] = sum(m.numel() for m in sure.values())
    skipped = update_err(start)[0]
    flipped = update_err({n: 2 * start[n] - gpu_p[n] for n in start})[0]
    print(f"  updates (after - before): {rec['updates_compared']} of "
          f"{rec['updates_total']} elements, worst relative error "
          f"{rec['updates']:.3e} ({where}; tol {TINY_REL_TOL}); a skipped step "
          f"scores {skipped:.3e}, a reversed one {flipped:.3e}", flush=True)
    if not rec["updates"] <= TINY_REL_TOL:
        m = sure[where]
        i = ((gpu_p[where] - cpu_p[where].detach()).abs() * m).argmax()
        raise AssertionError(
            f"updates differ in {where}: {rec['updates']} > {TINY_REL_TOL}; at "
            f"its worst element grad cpu {grads[where].flatten()[i].item()!r} "
            f"cuda {gpu_model.get_parameter(where).grad.flatten()[i].item()!r}, "
            f"update cpu {want[where].flatten()[i].item()!r} cuda "
            f"{(gpu_p[where] - start[where]).flatten()[i].item()!r}")
    if not min(skipped, flipped) > TINY_REL_TOL:
        raise AssertionError("the update check passes a skipped or reversed step")
    return rec


def phase_flagship_train(iters=10, lidar=False):
    if lidar:
        print("phase 18: full-width flagship LC train step (f32 params, bf16 "
              "autocast, modality dropout)", flush=True)
    else:
        print("phase 9: full-width flagship camera-only train step (f32 "
              "params, bf16 autocast)", flush=True)
    model = build_flagship(use_lidar=lidar, device="cuda", dtype=torch.bfloat16,
                           seed=0, train=True)
    batch = synthetic_batch(np.random.RandomState(0), device="cuda")
    return _train_run(model, batch, expected_train_launches(lidar), iters, 3,
                      lidar)


def _train_run(model, batch, expected, iters, warmups, lidar):
    """Train steps on ``model``: launch counts of one step (asserted against
    ``expected``), s/step (median of ``iters`` after ``warmups``), peak
    memory, finite losses, SCA overflow on the camera-live steps, frozen
    parameters bit-identical and, with ``lidar``, every LiDAR running
    statistic moved."""
    opt, sched = make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    stats0 = lidar_running_stats(model)
    for _ in range(warmups):
        train_step(model, opt, sched, batch, gen)
    torch.cuda.synchronize()

    for k in list(_build.launches):
        _build.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    metrics = train_step(model, opt, sched, batch, gen)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.launches.items() if v}
    peak = torch.cuda.max_memory_allocated()

    times, steps = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        m = train_step(model, opt, sched, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        steps.append({k: float(m[k]) for k in ("loss", "sca_overflow",
                                               "l_flag", "c_flag")})
    s_step = float(np.median(times))
    values = {k: float(v) for k, v in metrics.items()}
    finite = all(np.isfinite(v) for v in values.values()) and all(
        np.isfinite(st["loss"]) for st in steps)
    # the camera branch runs on every step; its overflow counts where the
    # fusion keeps it
    overflow = max([int(values["sca_overflow"])]
                   + [int(st["sca_overflow"]) for st in steps
                      if st["c_flag"] == 1.0])
    still = all(torch.equal(p, frozen[n]) for n, p in model.named_parameters()
                if n in frozen)
    stats = lidar_running_stats(model)
    moved = [n for n in stats if not torch.equal(stats[n], stats0[n])]
    flags = [(st["l_flag"], st["c_flag"]) for st in steps]
    rec = dict(s_per_step=s_step, s_min=min(times), s_max=max(times),
               iters=iters, times=times, peak_bytes=peak, launches=launches,
               expected_launches=expected, metrics=values, steps=steps,
               sca_overflow=overflow, finite=finite,
               frozen_params=len(frozen), frozen_unchanged=still,
               lidar_stats=len(stats), lidar_stats_moved=len(moved))
    print(f"  {s_step:.4f} s/step (median of {iters}; min {min(times):.4f}, "
          f"max {max(times):.4f}); peak {peak / 2 ** 30:.2f} GiB ({peak} "
          f"bytes); loss "
          f"{values['loss']:.4f} grad_norm {values['grad_norm']:.4f}; "
          f"sca_overflow {overflow}; {len(frozen)} frozen parameters "
          f"unchanged {still}; LiDAR running statistics moved {len(moved)} of "
          f"{len(stats)}", flush=True)
    if lidar:
        print(f"  flags (l, c) of the timed steps: {flags}", flush=True)
    print(f"  launches per step {launches} (expected {expected})", flush=True)
    if CHECK_LAUNCHES and launches != expected:
        raise AssertionError(f"launches per step {launches} != {expected}")
    if overflow != 0 or not finite or not still or not frozen:
        raise AssertionError(f"bad flagship train step: {rec}")
    if len(moved) != len(stats) or (lidar and not stats):
        raise AssertionError(f"LiDAR running statistics moved: {len(moved)} "
                             f"of {len(stats)}")
    return model, opt, sched, batch, gen, rec


# The flagship LiDAR branch (unibev_tpu_torch/flagship.py): voxel grid,
# SparseEncoder widths, strided paddings and row capacities.
VOXEL_GRID = (1440, 1440, 40)
SPARSE_SHAPE = (41, 1440, 1440)
ENCODER_CHANNELS = ((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128))
DOWN_PADDINGS = ((1, 1, 1), (1, 1, 1), (0, 1, 1))
CAPACITIES = (120000, 90000, 60000, 40000)


def lidar_sites(points, voxel=(VOXEL_SIZE, PC_RANGE, VOXEL_GRID),
                sparse_shape=SPARSE_SHAPE, capacities=CAPACITIES):
    """The flagship LiDAR branch's rulebooks on one cloud, as the
    SparseEncoder builds them: (K6 sites, K7 sites, K8 sites, counts).

    A K6 site is (name, sparse_nbr arguments); a K7 site (also K9's) is
    (name, calls per forward, Cin, Cout, rows of its input, rulebook, output
    mask); a K8 site is (name, sparse_inv_nbr arguments) of a strided conv.
    The counts are the voxels before the cap and each strided conv's
    overflow, and ``grid`` the res-0 active set.
    """
    mask = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    vox = voxelize_and_encode(points, mask, *voxel, capacities[0])
    zero = torch.zeros_like(vox.coords[:, :1])
    coords = torch.where(vox.mask[:, None], torch.cat([zero, vox.coords], 1), -1)
    grid = SparseGrid(coords.contiguous(), vox.mask, sparse_shape, 1)
    table = build_table(grid)
    k6, k7, k8, overflow = [], [], [], []
    counts = dict(grid=grid)

    def subm(i, grid, table):
        args = (table, grid.coords.shape[0], grid.shape, grid.coords,
                grid.mask, (3, 3, 3), (1, 1, 1), (1, 1, 1))
        k6.append((f"subm{i}", args))
        return sparse_nbr_reference(*args)

    def strided(name, grid, table, kernel, stride, padding, capacity):
        out_shape = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                          zip(grid.shape, padding, kernel, stride))
        co, mo, table_out, over = downsample_with_table(
            grid, kernel, stride, padding, out_shape, capacity)
        args = (table, grid.coords.shape[0], grid.shape, co, mo, kernel,
                stride, padding)
        k6.append((name, args))
        k8.append((name, (table_out, capacity, out_shape, grid.coords,
                          grid.mask, kernel, stride, padding)))
        overflow.append(int(over))
        return (SparseGrid(co, mo, out_shape, 1), table_out,
                sparse_nbr_reference(*args))

    nidx = subm(0, grid, table)
    c0 = ENCODER_CHANNELS[0][0]
    k7.append(("conv_input", 1, 5, c0, grid.coords.shape[0], nidx, grid.mask))
    k7.append(("subm0", 4, c0, c0, grid.coords.shape[0], nidx, grid.mask))
    for i, pad in enumerate(DOWN_PADDINGS):
        rows = grid.coords.shape[0]
        grid, table, sidx = strided(f"down{i}", grid, table, (3, 3, 3),
                                    (2, 2, 2), pad, capacities[i + 1])
        cin, cout = ENCODER_CHANNELS[i][1], ENCODER_CHANNELS[i][2]
        k7.append((f"down{i}", 1, cin, cout, rows, sidx, grid.mask))
        nidx = subm(i + 1, grid, table)
        k7.append((f"subm{i + 1}", 4, cout, cout, grid.coords.shape[0], nidx,
                   grid.mask))
    rows = grid.coords.shape[0]
    grid, _, sidx = strided("conv_out", grid, table, (3, 1, 1), (2, 1, 1),
                            (0, 0, 0), capacities[-1])
    k7.append(("conv_out", 1, 128, 128, rows, sidx, grid.mask))
    counts.update(num_distinct_voxels=int(vox.num_distinct),
                  num_voxels=int(vox.num_voxels), sparse_overflow=overflow)
    return k6, k7, k8, counts


def _live(idx, sentinel):
    """Rulebook entries that hold a row: the taps this run's data has."""
    return int((idx < sentinel).sum())


# The strided convs of one SparseEncoder forward: (kernel, stride, padding,
# capacity of the output rows)
STRIDED_CONVS = [((3, 3, 3), (2, 2, 2), p, c)
                 for p, c in zip(DOWN_PADDINGS, CAPACITIES[1:])] + [
                     ((3, 1, 1), (2, 1, 1), (0, 0, 0), CAPACITIES[-1])]


def _tables_of_a_forward(grid):
    """The compact tables of one SparseEncoder forward: build_table at res 0
    and the four downsample_with_table calls (the strided convs' active
    sets)."""
    build_table(grid)
    for kernel, stride, padding, capacity in STRIDED_CONVS:
        out_shape = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                          zip(grid.shape, padding, kernel, stride))
        co, mo, _, _ = downsample_with_table(grid, kernel, stride, padding,
                                             out_shape, capacity)
        grid = SparseGrid(co, mo, out_shape, grid.batch)


def _table_bytes(table, cells, ok):
    """Bytes of a compact table that lookups of ``cells`` where ``ok`` must
    read, each at most once: the word of every cell looked up, the count of
    every word that holds a set one, and the map entry of every cell that
    holds a row."""
    # imported here: --compare runs this script in checkouts without it
    from unibev_tpu_torch.ops.sparse_conv import table_lookup
    cells = torch.unique(cells[ok])
    words = cells >> 5
    is_set = ((table.bits[words] >> (cells & 31)) & 1) == 1
    rows = int((table_lookup(table, cells, -1) >= 0).sum())
    return 4 * (torch.unique(words).numel()
                + torch.unique(words[is_set]).numel() + rows)


def phase_sparse(gen):
    print("phase 11: K6 sparse_nbr and K7 sparse_conv vs their plain versions "
          "at the flagship LiDAR sites", flush=True)
    points = synthetic_batch(np.random.RandomState(0), device="cuda")["points"][0]
    k6, k7, _, counts = lidar_sites(points)
    mask = torch.ones(points.shape[0], dtype=torch.bool, device="cuda")
    counts["voxelizer_ms"] = cuda_ms(lambda: voxelize_and_encode(
        points, mask, VOXEL_SIZE, PC_RANGE, VOXEL_GRID, CAPACITIES[0]), 10)
    # points and mask in; per voxel f32 features, int32 coords and mask out
    P, F = points.shape
    counts["voxelizer_bound_ms"] = ((4 * F + 1) * P + (4 * F + 13)
                                    * CAPACITIES[0]) / HBM_BYTES_PER_S * 1e3
    grid = counts.pop("grid")
    print(f"  voxelized synthetic batch: {counts}", flush=True)
    counts["tables_device_ms"] = device_ms(lambda: _tables_of_a_forward(grid),
                                           5)
    counts["tables_ms"] = cuda_ms(lambda: _tables_of_a_forward(grid), 5)
    print(f"  the compact tables of one forward (build_table and 4 "
          f"downsample_with_table): device {counts['tables_device_ms']:.4f} "
          f"ms, events {counts['tables_ms']:.4f} ms", flush=True)
    from unibev_tpu_torch.ops.sparse_conv import rulebook_cells
    rec6 = new_rec()
    for name, args in k6:
        got, want = sparse_nbr(*args), sparse_nbr_reference(*args)
        if not torch.equal(got, want):
            raise AssertionError(f"K6 {name}: {int((got != want).sum())} "
                                 f"entries differ from the plain version")
        ms = cuda_ms(lambda: sparse_nbr(*args), 20)
        dev = device_ms(lambda: sparse_nbr(*args), 20)
        plain = cuda_ms(lambda: sparse_nbr_reference(*args), 5)
        live = _live(want, args[1])
        Vout, K = want.shape
        table = _table_bytes(args[0], *rulebook_cells(*args[2:]))
        # coords and mask in, the rulebook out, the table's bytes it reads
        bound = add_site(rec6, name, 1, ms, plain, 0.0,
                         17 * Vout + 4 * Vout * K + table, 0,
                         shape=[Vout, K], live=live, table_bytes=table,
                         device_ms=dev, before_ms=K6_BEFORE_MS[name])
        print(f"  K6 {name}: {(Vout, K)} equal ({live} live entries, "
              f"{table} table bytes); kernel {ms:.4f} ms (device {dev:.4f}), "
              f"plain {plain:.4f} ms, bound {bound:.4f} ms, before "
              f"{K6_BEFORE_MS[name]:.4f} ms", flush=True)
    rec6["device_ms"] = sum(v["device_ms"] for v in rec6["sites"].values())
    ratio_line(f"K6 over the 8 launches of one forward (device "
               f"{rec6['device_ms']:.4f} ms; before "
               f"{sum(K6_BEFORE_MS.values()):.4f} ms)", rec6)
    rec7 = new_rec()
    for name, calls, cin, cout, rows, nidx, mask in k7:
        Vout, K = nidx.shape
        for dtype in (torch.float32, torch.bfloat16):
            feats = torch.randn(rows, cin, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(K * cin, cout, device="cuda", generator=gen)
                 * (K * cin) ** -0.5).to(dtype)
            err = check(f"K7 {name} {str(dtype)[6:]}", sparse_conv(feats, nidx, w, mask),
                        sparse_conv_reference(feats, nidx, w, mask), REL_TOL[dtype])
            if dtype is torch.bfloat16:
                ms = cuda_ms(lambda: sparse_conv(feats, nidx, w, mask), 10)
                plain = cuda_ms(lambda: sparse_conv_reference(feats, nidx, w, mask), 5)
                live = _live(nidx, rows)
                # feats, rulebook, weight, mask, out; a product per live tap
                bound = add_site(rec7, name, calls, ms, plain, err,
                                 2 * rows * cin + 4 * Vout * K
                                 + 2 * K * cin * cout + Vout + 2 * Vout * cout,
                                 2 * live * cin * cout, live=live)
                print(f"  K7 {name} bf16 ({Vout} x {K} taps, {live} live, {cin} "
                      f"-> {cout}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                      f"kernel/plain {ms / plain:.4f}, bound {bound:.4f} ms "
                      f"(x{calls} per forward)", flush=True)
    ratio_line("K7 over the 21 launches of one LC forward", rec7)
    del k6, k7
    torch.cuda.empty_cache()
    return rec6, rec7, counts


def phase_sparse_backward(gen):
    print("phase 16: the sparse conv's backward at the flagship LiDAR sites: "
          "K8 sparse_inv_nbr, K9 sparse_conv_wgrad and SparseConvFn's d_feats "
          "(K7) vs their plain versions", flush=True)
    # imported here: --compare runs this script in checkouts without it
    from unibev_tpu_torch.ops.sparse_conv import wgrad_plan
    points = synthetic_batch(np.random.RandomState(0), device="cuda")["points"][0]
    _, k7, k8, _ = lidar_sites(points)
    rec8, rec9, rec_df = new_rec(), new_rec(), new_rec()
    inv = {}
    from unibev_tpu_torch.ops.sparse_conv import inverse_cells
    for name, args in k8:
        got, want = sparse_inv_nbr(*args), sparse_inv_nbr_reference(*args)
        if not torch.equal(got, want):
            raise AssertionError(f"K8 {name}: {int((got != want).sum())} "
                                 f"entries differ from the plain version")
        ms = cuda_ms(lambda: sparse_inv_nbr(*args), 20)
        dev = device_ms(lambda: sparse_inv_nbr(*args), 20)
        plain = cuda_ms(lambda: sparse_inv_nbr_reference(*args), 5)
        live = _live(want, args[1])
        Vin, K = want.shape
        table = _table_bytes(args[0], *inverse_cells(*args[2:]))
        bound = add_site(rec8, name, 1, ms, plain, 0.0,
                         17 * Vin + 4 * Vin * K + table, 0,
                         shape=[Vin, K], live=live, table_bytes=table,
                         device_ms=dev, before_ms=K8_BEFORE_MS[name])
        print(f"  K8 {name}: {(Vin, K)} equal ({live} live entries, {table} "
              f"table bytes); kernel {ms:.4f} ms (device {dev:.4f}), plain "
              f"{plain:.4f} ms, bound {bound:.4f} ms, before "
              f"{K8_BEFORE_MS[name]:.4f} ms", flush=True)
        inv[name] = want
    rec8["device_ms"] = sum(v["device_ms"] for v in rec8["sites"].values())
    ratio_line(f"K8 over the 4 launches of one step (device "
               f"{rec8['device_ms']:.4f} ms; before "
               f"{sum(K8_BEFORE_MS.values()):.4f} ms)", rec8)
    for name, calls, cin, cout, rows, nidx, mask in k7:
        Vout, K = nidx.shape
        live = _live(nidx, rows)
        for dtype in (torch.float32, torch.bfloat16):
            errs = []
            for call in range(calls):       # each launch of a step, new data
                feats = torch.randn(rows, cin, device="cuda", generator=gen).to(dtype)
                g = torch.randn(Vout, cout, device="cuda", generator=gen).to(dtype)
                errs.append(check(
                    f"K9 {name}{f' #{call}' if calls > 1 else ''} "
                    f"{str(dtype)[6:]}", sparse_conv_wgrad(feats, nidx, g),
                    sparse_conv_wgrad_reference(feats, nidx, g),
                    WGRAD_REL_TOL[dtype]))
            err = max(errs)
            if dtype is torch.bfloat16:
                ms = cuda_ms(lambda: sparse_conv_wgrad(feats, nidx, g), 10)
                plain = cuda_ms(lambda: sparse_conv_wgrad_reference(feats, nidx, g), 5)
                before = K9_BEFORE_MS[name]
                plan = wgrad_plan(Vout, K, cin, cout, 2,
                                  _build.sm_count(feats.device.index))
                # feats, rulebook, g in, the float32 dW out
                bound = add_site(rec9, name, calls, ms, plain, err,
                                 2 * rows * cin + 4 * Vout * K + 2 * Vout * cout
                                 + 4 * K * cin * cout, 2 * live * cin * cout,
                                 live=live, before_ms=before,
                                 plan=plan._asdict())
                print(f"  K9 {name} bf16 ({Vout} x {K} taps, {live} live, {cin} "
                      f"-> {cout}; span {plan.span}, item {plan.chunk} rows, "
                      f"{plan.grid[0]} blocks): kernel {ms:.4f} ms, plain "
                      f"{plain:.4f} ms, kernel/plain {ms / plain:.4f}, bound "
                      f"{bound:.4f} ms, kernel/bound {ms / bound:.1f}, before "
                      f"{before:.3f} ms, kernel/before {ms / before:.4f} "
                      f"(x{calls} per step)", flush=True)
        if name == "conv_input":
            continue            # the voxel features take no gradient
        subm = name.startswith("subm")
        idx = nidx if subm else inv[name]
        for dtype in (torch.float32, torch.bfloat16):
            feats = torch.randn(rows, cin, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(K * cin, cout, device="cuda", generator=gen)
                 * (K * cin) ** -0.5).to(dtype)
            g = torch.randn(Vout, cout, device="cuda", generator=gen).to(dtype)
            f = feats.clone().requires_grad_()
            got = torch.autograd.grad(sparse_conv(f, nidx, w, mask,
                                                  None if subm else idx), f, g)[0]
            # held against the plain backward in float32 on the same
            # (bf16-exact) values: a bf16 plain backward rounds every
            # scattered row, the kernel only its float32 sums
            want = _plain_backward(
                lambda x: sparse_conv_reference(x, nidx, w.float(), mask),
                (feats.float(),), g.float())()[0]
            err = check(f"d_feats {name} {str(dtype)[6:]}", got, want,
                        BWD_REL_TOL[dtype])
            del got, want
            if dtype is torch.bfloat16:
                plain = _plain_backward(
                    lambda x: sparse_conv_reference(x, nidx, w, mask), (feats,), g)
                # the backward's K7 launch alone, at the transposed shape
                gm = torch.where(mask[:, None], g, 0.0).contiguous()
                wt = tap_transpose(w, K, subm)
                out_mask = mask if subm else torch.ones(
                    rows, dtype=torch.bool, device="cuda")
                ms = cuda_ms(lambda: gather_conv(gm, idx, wt, out_mask), 10)
                plain_ms = cuda_ms(plain, 3)
                bound = add_site(rec_df, name, calls, ms, plain_ms, err,
                                 2 * Vout * cout + 4 * rows * K
                                 + 2 * K * cin * cout + rows + 2 * rows * cin,
                                 2 * live * cin * cout, live=live)
                print(f"  K7 d_feats {name} bf16 ({rows} x {K} taps, {cout} -> "
                      f"{cin}): kernel {ms:.4f} ms, plain backward "
                      f"{plain_ms:.4f} ms, kernel/plain {ms / plain_ms:.4f}, "
                      f"bound {bound:.4f} ms (x{calls} per step)", flush=True)
                del plain
    ratio_line("K9 over the 21 launches of one LC train step", rec9)
    print(f"  K9 over the step: kernel {rec9['ms']:.4f} ms against "
          f"{K9_BEFORE_STEP_MS} ms before its tensor-core design, "
          f"kernel/before {rec9['ms'] / K9_BEFORE_STEP_MS:.4f}", flush=True)
    ratio_line("K7 as d_feats over the 20 launches of one LC train step",
               rec_df)
    del k7, k8, inv
    torch.cuda.empty_cache()
    return rec8, rec9, rec_df


def phase_tiny_lc():
    print("phase 12: tiny LC model in LC and L mode, CUDA kernels vs CPU plain "
          "versions", flush=True)
    cpu_model = build_model(tiny_model_cfg(use_lidar=True), "cpu", seed=0)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    full = tiny_batch(np.random.RandomState(0))
    rec = {}
    for mode, drop in (("LC", ()), ("L", ("img",))):
        batch = {k: v for k, v in full.items() if k not in drop}
        gpu_batch = {k: v.to("cuda") for k, v in batch.items()}
        before = dict(_build.launches)
        with torch.inference_mode():
            want, got = cpu_model(batch), gpu_model(gpu_batch)
        launched = {k for k, v in _build.launches.items() if v > before.get(k, 0)}
        if not {"sparse_nbr", "sparse_conv", "msda_fwd"} <= launched:
            raise AssertionError(f"tiny {mode} on CUDA launched only {launched}")
        for k in ("all_cls_scores", "all_bbox_preds"):
            rec[f"{mode} {k}"] = check(f"{mode} {k}", got[k].cpu(), want[k],
                                       TINY_REL_TOL)
        if not torch.equal(got["sparse_overflow"].cpu(), want["sparse_overflow"]):
            raise AssertionError(f"{mode}: sparse overflow differs")
        want, got = cpu_model.predict(batch), gpu_model.predict(gpu_batch)
        if not torch.equal(got["labels"].cpu(), want["labels"]):
            raise AssertionError(f"{mode}: decoded labels differ between CUDA and CPU")
        for k in ("scores", "bboxes"):
            rec[f"{mode} {k}"] = check(f"{mode} decoded {k}", got[k].cpu(),
                                       want[k], TINY_REL_TOL)
    return rec


def _predict_run(model, batch, iters, expected, label, warmups=3):
    """Launch counts of one predict (asserted against ``expected``), peak
    memory, and ms per sample (median of ``iters`` after ``warmups``)."""
    for _ in range(warmups):
        model.predict(batch)
    torch.cuda.synchronize()
    for k in list(_build.launches):
        _build.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    out = model.predict(batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.launches.items() if v}
    peak = torch.cuda.max_memory_allocated()
    times = []
    B = out["bboxes"].shape[0]
    for _ in range(iters):
        t0 = time.perf_counter()
        model.predict(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000 / B)
    ms = float(np.median(times))
    boxes, scores = out["bboxes"], out["scores"]
    finite = bool(torch.isfinite(boxes).all() and torch.isfinite(scores).all())
    # without points (C predict) there are no voxel counts
    rec = dict(ms_per_sample=ms, ms_min=min(times), ms_max=max(times),
               iters=iters, peak_bytes=peak, launches=launches,
               sca_overflow=int(out["sca_overflow"]), boxes_finite=finite,
               boxes_shape=list(boxes.shape), n_valid=int(out["valid"].sum()),
               num_distinct_voxels=out.get("num_distinct_voxels",
                                           torch.zeros(0)).tolist(),
               sparse_overflow=out.get("sparse_overflow",
                                       torch.zeros(0)).tolist())
    print(f"  {label}: {ms:.2f} ms/sample (median of {iters}; min "
          f"{min(times):.2f}, max {max(times):.2f}); peak "
          f"{peak / 2 ** 30:.2f} GiB ({peak} bytes); launches per forward "
          f"{launches}; "
          f"sca_overflow {rec['sca_overflow']}; boxes finite {finite} "
          f"{tuple(boxes.shape)}; voxels before the cap "
          f"{rec['num_distinct_voxels']}, strided-conv overflow "
          f"{rec['sparse_overflow']}", flush=True)
    if CHECK_LAUNCHES and launches != expected:
        raise AssertionError(f"{label}: expected launches {expected}, got {launches}")
    if rec["sca_overflow"] != 0 or not finite or tuple(boxes.shape) != (1, 300, 9):
        raise AssertionError(f"bad flagship {label} output: {rec}")
    return rec


def phase_flagship_lc(iters=10):
    print("phase 13: full-width flagship LC predict, bf16", flush=True)
    model = build_flagship(device="cuda", dtype=torch.bfloat16, seed=0)
    batch = synthetic_batch(np.random.RandomState(0), device="cuda")
    rec = _predict_run(model, batch, iters, expected_predict_launches(), "LC")
    return model, batch, rec


def phase_flagship_l(model, batch, iters=10):
    print("phase 14: L predict on the same model (no images), bf16", flush=True)
    batch = {k: v for k, v in batch.items() if k != "img"}
    return batch, _predict_run(model, batch, iters,
                               expected_predict_launches(camera=False), "L")



def _category(kernel_name):
    n = kernel_name.lower()
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


# CUDA runtime calls in which the host waits for the card
WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy")


def _profile(run, wall_ms):
    """Device time by kernel category of one traced ``run``, its idle share
    against ``wall_ms``, and the host's time in the traced run: its wall
    less the time the host spent in WAIT_CALLS (tracing adds to it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1000
    # kernels only: the optimizer's record_function range ("Optimizer.step#
    # AdamW.step") also shows as a device event and would count its kernels
    # twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
              and not e.key.startswith("Optimizer.")]
    if not events:
        raise AssertionError("the profiler recorded no device kernels")
    events.sort(key=lambda e: -e.self_device_time_total)
    total_ms = sum(e.self_device_time_total for e in events) / 1000
    by_cat = {}
    for e in events:
        cat = _category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1000
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {cat}", flush=True)
    idle = 1.0 - total_ms / wall_ms
    print(f"  device busy {total_ms:.3f} ms of {wall_ms:.3f} ms wall: "
          f"idle share {idle:.3f}", flush=True)
    waits = [e for e in prof.key_averages() if e.key in WAIT_CALLS]
    wait_ms = sum(e.self_cpu_time_total for e in waits) / 1000
    print(f"  host: traced run {traced_ms:.3f} ms, of which {wait_ms:.3f} ms "
          f"in {sum(e.count for e in waits)} waiting calls; host time "
          f"{traced_ms - wait_ms:.3f} ms", flush=True)
    top = [dict(name=e.key[:120], calls=e.count,
                device_ms=e.self_device_time_total / 1000) for e in events[:30]]
    return dict(device_ms_total=total_ms, idle_share=idle, by_category=by_cat,
                traced_ms=traced_ms, wait_ms=wait_ms,
                host_ms=traced_ms - wait_ms, top=top)


def phase_profile(model, batch, wall_ms):
    print("phase 6: torch.profiler breakdown of one forward (device kernels)",
          flush=True)
    return _profile(lambda: model.predict(batch), wall_ms)


def phase_profile_lidar(model, lc_batch, l_batch, lc_ms, l_ms):
    print("phase 15: torch.profiler breakdowns of one LC and one L forward "
          "(device kernels; in L the convolutions are SECOND's and "
          "SECONDFPN's alone)", flush=True)
    print("  LC:", flush=True)
    lc = _profile(lambda: model.predict(lc_batch), lc_ms)
    print("  L:", flush=True)
    return lc, _profile(lambda: model.predict(l_batch), l_ms)


def phase_profile_train(model, opt, sched, batch, gen, wall_ms, lidar=False):
    print(f"phase {19 if lidar else 10}: torch.profiler breakdown of one "
          f"{'LC' if lidar else 'C'} train step (device kernels)", flush=True)
    rec = _profile(lambda: train_step(model, opt, sched, batch, gen), wall_ms)
    cats = ("K3 msda_bwd", "K4 dcn_bwd", "K5 scatter_add_rows")
    rec["sampling_backwards_ms"] = sum(rec["by_category"].get(c, 0.0)
                                       for c in cats)
    print(f"  K3 + K4 + K5: {rec['sampling_backwards_ms']:.3f} ms of device "
          f"time", flush=True)
    return rec


def phase_msda_d16(gen):
    # imported here: --compare also runs against checkouts that predate them
    from unibev_tpu_torch.ops.msda import msda_bwd_plan, msda_fwd_route
    print("phase 20: K1 msda_fwd and K3 msda_bwd vs their plain versions at "
          "the cat_128 config's D = 16 sites", flush=True)
    fwd, bwd = new_rec(), new_rec()
    bwd["device_ms"] = 0.0
    for name, calls, B, V, Q, heads, D, levels, P in CAT_MSDA_SITES:
        pts = B * Q * heads * len(levels) * P
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{name} {str(dtype)[6:]}"
            value, loc, attn = _msda_inputs(gen, B, V, Q, heads, D, levels, P,
                                            dtype)
            err = check(f"{tag} K1", ms_deform_attn(value, levels, loc, attn),
                        ms_deform_attn_reference(value, levels, loc, attn),
                        REL_TOL[dtype])
            vec = msda_fwd_route(D, value.element_size(), value.data_ptr())
            g = torch.randn(B, Q, heads * D, device="cuda", generator=gen).to(dtype)
            before = dict(_build.launches)
            got = ms_deform_attn_backward(value, levels, loc, attn, g)
            torch.cuda.synchronize()
            grew = {k: v - before.get(k, 0) for k, v in _build.launches.items()
                    if v != before.get(k, 0)}
            if grew != {"msda_bwd": 1}:
                raise AssertionError(f"one backward call launched {grew}")
            plain = _plain_backward(
                lambda v, l, a: ms_deform_attn_reference(v, levels, l, a),
                (value, loc, attn), g)
            interior = cell_interior(loc, levels)
            errs = [check(f"{tag} K3 {n}", a * m, b * m, BWD_REL_TOL[dtype])
                    for n, a, b, m in zip(("d_value", "d_loc", "d_attn"), got,
                                          plain(), (1, interior, 1))]
            plan = msda_bwd_plan(B, V, Q, heads, D, value.element_size(),
                                 value.data_ptr(), g.data_ptr())
            print(f"  {tag}: K1 {vec}-byte loads; K3 plan {plan._asdict()}",
                  flush=True)
            if dtype is torch.bfloat16:
                # as phases 2 and 7 count them
                gathered = min(2 * B * V * heads * D, 4 * pts * 2 * D)
                ms = cuda_ms(lambda: ms_deform_attn(value, levels, loc, attn), 20)
                pl = cuda_ms(lambda: ms_deform_attn_reference(value, levels, loc,
                                                              attn), 5)
                bound = add_site(fwd, name, calls, ms, pl, err,
                                 gathered + 10 * pts + 2 * B * Q * heads * D,
                                 8 * D * pts, vec_bytes=vec)
                print(f"  {name} bf16 K1: kernel {ms:.4f} ms, plain {pl:.4f} ms, "
                      f"bound {bound:.4f} ms (x{calls} per forward)", flush=True)
                run = lambda: ms_deform_attn_backward(value, levels, loc, attn, g)  # noqa: E731
                ms, pl, dev = cuda_ms(run, 10), cuda_ms(plain, 3), device_ms(run, 5)
                bound = add_site(bwd, name, calls, ms, pl, max(errs),
                                 4 * B * V * heads * D + 20 * pts
                                 + 2 * B * Q * heads * D, 24 * D * pts,
                                 device_ms=dev, plan=plan._asdict())
                bwd["device_ms"] += calls * dev
                print(f"  {name} bf16 K3: kernel {ms:.4f} ms (device {dev:.4f} "
                      f"ms), plain {pl:.4f} ms, bound {bound:.4f} ms (x{calls} "
                      f"per step)", flush=True)
            del plain, got
    ratio_line("K1 over cat_128's 12 D = 16 launches of one LC forward", fwd)
    ratio_line("K3 over cat_128's 12 D = 16 launches of one LC step", bwd)
    torch.cuda.empty_cache()
    return fwd, bwd


def phase_tiny_variants():
    print("phase 21: the tiny LC model with avg fusion, cat fusion and dual "
          "queries, CUDA kernels vs CPU plain versions: predict, and the "
          "losses and gradients of one forward with the LiDAR modules in "
          "train mode", flush=True)
    forward = {"msda_fwd", "dcn_fwd", "sparse_nbr", "sparse_conv"}
    backward = {"msda_bwd", "dcn_bwd", "dcn_im2col", "sparse_inv_nbr",
                "sparse_conv_wgrad"}
    batch = tiny_batch(np.random.RandomState(0))
    gpu_batch = {k: v.to("cuda") for k, v in batch.items()}
    rec = {}
    for variant, kw in TINY_VARIANTS.items():
        cfg = tiny_model_cfg(use_lidar=True, **kw)
        cpu_model = build_model(cfg, "cpu", seed=0)
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
        before = dict(_build.launches)
        want, got = cpu_model.predict(batch), gpu_model.predict(gpu_batch)
        launched = {k for k, v in _build.launches.items() if v > before.get(k, 0)}
        if not forward <= launched:
            raise AssertionError(f"{variant} predict on CUDA launched only {launched}")
        if not torch.equal(got["labels"].cpu(), want["labels"]):
            raise AssertionError(f"{variant}: decoded labels differ")
        for k in ("scores", "bboxes"):
            rec[f"{variant} {k}"] = check(f"{variant} decoded {k}", got[k].cpu(),
                                          want[k], TINY_REL_TOL)

        models = [build_model(cfg, "cpu", seed=0, train=True).eval()]
        for name in LIDAR_MODULES:
            getattr(models[0], name).train()      # batch statistics; no draws
        models.append(copy.deepcopy(models[0]).to("cuda"))
        losses = []
        before = dict(_build.launches)
        for model, b in zip(models, (batch, gpu_batch)):
            out = model.loss(b, model(b))
            sum(out.values()).backward()
            losses.append(out)
        torch.cuda.synchronize()
        launched = {k for k, v in _build.launches.items() if v > before.get(k, 0)}
        if not forward | backward <= launched:
            raise AssertionError(f"{variant} step on CUDA launched only {launched}")
        grads = {n: p.grad for n, p in models[0].named_parameters()
                 if p.grad is not None}
        rec[f"{variant} losses"] = check_each(f"{variant} losses", losses[1],
                                              losses[0], TINY_REL_TOL)
        rec[f"{variant} grads"] = check_each(
            f"{variant} gradients",
            {n: models[1].get_parameter(n).grad for n in grads}, grads,
            TINY_REL_TOL)
    return rec


def phase_configs(iters=3):
    print("phase 22: full-width LC predict of the avg_256, dual-queries and "
          "cat_128 configs, each built from its file (cat_128: float32, dense "
          "camera SCA); on the avg model also L and C predict", flush=True)
    batch = synthetic_batch(np.random.RandomState(0), device="cuda")
    rec = {}
    for name, path in CONFIGS.items():
        model = build_model_from_config(path, "cuda", seed=0)
        t = model.pts_bbox_head.transformer
        print(f"  {name}: {os.path.relpath(path, ROOT)}: {model.compute_dtype}, "
              f"fusion {t.fusion_method}, feature_norm {t.feature_norm}, "
              f"embed_dims {t.embed_dims}, decoder {t.dec_dims}, dual queries "
              f"{t.dual_queries}, camera SCA rebatch_k "
              f"{t.img_bev_encoder.rebatch_k}", flush=True)
        modes = {"LC": (batch, expected_predict_launches())}
        if name == "avg_256":
            modes["L"] = ({k: v for k, v in batch.items() if k != "img"},
                          expected_predict_launches(camera=False))
            modes["C"] = ({k: v for k, v in batch.items()
                           if k not in ("points", "points_mask")},
                          expected_predict_launches(lidar=False))
        for mode, (b, expected) in modes.items():
            label = f"{name} {mode}"
            run = _predict_run(model, b, iters, expected, label, warmups=1)
            run["profile"] = _profile(lambda: model.predict(b),
                                      run["ms_per_sample"])
            rec[label] = run
        if name == "cat_128":
            # every run above convolves float32 with cuDNN's TF32 off, as
            # all of this script's checks do; PyTorch's default turns it on
            torch.backends.cudnn.allow_tf32 = True
            try:
                rec["cat_128 LC, cuDNN TF32"] = _predict_run(
                    model, batch, iters, expected_predict_launches(),
                    "cat_128 LC, cuDNN TF32 on", warmups=1)
            finally:
                torch.backends.cudnn.allow_tf32 = False
        del model
        torch.cuda.empty_cache()
    return rec


def phase_cat_train(iters=2):
    print("phase 23: one full-width LC train step of the cat_128 config built "
          "from its file: float32 parameters and compute (no autocast), dense "
          "camera SCA, modality dropout", flush=True)
    model = build_model_from_config(CONFIGS["cat_128"], "cuda", seed=0,
                                    train=True)
    if model.compute_dtype != torch.float32:
        raise AssertionError(f"cat_128 computes in {model.compute_dtype}")
    batch = synthetic_batch(np.random.RandomState(0), device="cuda")
    out = _train_run(model, batch, expected_train_launches(lidar=True), iters,
                     1, lidar=True)
    rec = out[-1]
    del model, out
    torch.cuda.empty_cache()
    return rec


# The train / test CLI phases (24, 25): the flagship config file, the L-only
# inference config that evaluates its checkpoint, and the CLIs' work dir
# (under build/, which git ignores: a flagship checkpoint is large)
FLAGSHIP_CONFIG = os.path.join(
    ROOT, "configs", "unibev", "unibev_nus_LC_cnw_256_modality_dropout.py")
L_CONFIG = os.path.join(ROOT, "configs", "unibev", "inference",
                        "unibev_val_L_full.py")
CLI_DIR = os.path.join(ROOT, "build", "cli_smoke")
CLI_STEPS = 4


def _counts_during(fn):
    """(fn's result, the kernel launches it made): the counts are set to 0
    just before and read just after."""
    for k in list(_build.launches):
        _build.launches[k] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _build.launches.items() if v}


def _times(n, per):
    return {k: n * v for k, v in per.items()}


def _step_rows(steps, *keys):
    """(loss, data_time, time, *keys) of each metrics.jsonl step."""
    return [tuple(round(st[k], 4) for k in ("loss", "data_time", "time"))
            + tuple(st[k] for k in keys) for st in steps]


def phase_train_cli(step_launches, step_device_ms):
    print(f"phase 24: the port's train CLI in process on the flagship config "
          f"file, --synthetic-data, {CLI_STEPS} steps (6 cameras at 928x1600, "
          f"300k points, B=1, bf16, modality dropout)", flush=True)
    from unibev_tpu_torch.tools import train_UniBEV
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    work_dir = os.path.join(CLI_DIR, "train")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc, launches = _counts_during(lambda: train_UniBEV.main([
        FLAGSHIP_CONFIG, "--synthetic-data", "--max-steps", str(CLI_STEPS),
        "--work-dir", work_dir, "--cfg-options", "log_config.interval=1"]))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    ckpt = os.path.join(work_dir, "checkpoints", f"{CLI_STEPS}.pth")
    expected = _times(CLI_STEPS, step_launches)
    # steps 2 to 4: the first includes the model's build and cuDNN's choices
    s_step = float(np.median([st["time"] for st in steps[1:]]))
    wait = float(np.median([st["data_time"] for st in steps[1:]]))
    copy_ms = float(np.median([st["copy_ms"] for st in steps[1:]]))
    overflow = max(int(st["sca_overflow"]) for st in steps
                   if st["c_flag"] == 1.0) if any(
        st["c_flag"] == 1.0 for st in steps) else 0
    idle = 1.0 - step_device_ms / (1000 * s_step)
    # 4 steps run on the batches the workers loaded during the first step;
    # the loader's own rate, with no training beside it, says whether it
    # keeps up with a longer run
    from unibev_tpu_torch.data.loader import DataLoader
    from unibev_tpu_torch.data.nuscenes_dataset import SyntheticNuScenes
    loader = DataLoader(SyntheticNuScenes(length=12), batch_size=1,
                        num_workers=2, pin_memory=True)
    gaps, t0 = [], time.perf_counter()
    for _ in loader:
        gaps.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
    loader_s = float(np.median(gaps[-6:]))
    rec = dict(rc=rc, wall_s=wall, steps=steps, s_per_step=s_step,
               loader_wait_s=wait, loader_s_per_batch=loader_s,
               copy_ms=copy_ms, peak_bytes=peak,
               launches=launches, expected_launches=expected,
               sca_overflow=overflow, idle_share_estimate=idle,
               checkpoint_bytes=os.path.getsize(ckpt)
               if os.path.exists(ckpt) else None)
    print(f"  {s_step:.4f} s/step (median of steps 2-{CLI_STEPS}); loader "
          f"wait {wait:.4f} s/step, host-to-device copy {copy_ms:.3f} "
          f"ms/step; "
          f"idle share ~{idle:.3f} (phase 19's {step_device_ms:.3f} ms of "
          f"device a step over it); peak {peak / 2 ** 30:.2f} GiB ({peak} "
          f"bytes); {wall:.1f} s for the whole CLI call; the loader alone "
          f"(2 workers, pinned): {loader_s:.4f} s a batch (median of the "
          f"last 6 of 12)", flush=True)
    print(f"  steps (loss, data_time s, time s, l_flag, c_flag): "
          f"{_step_rows(steps, 'l_flag', 'c_flag')}", flush=True)
    print(f"  launches {launches} (expected {CLI_STEPS} x phase 18's: "
          f"{expected}); checkpoint {ckpt} ({rec['checkpoint_bytes']} bytes)",
          flush=True)
    if rc != 0 or len(steps) != CLI_STEPS or not all(
            np.isfinite(st["loss"]) for st in steps):
        raise AssertionError(f"train CLI: rc {rc}, steps {steps}")
    if not os.path.isfile(ckpt):
        raise AssertionError(f"train CLI: no checkpoint at {ckpt}")
    if overflow != 0:
        raise AssertionError(f"train CLI: sca_overflow {overflow}")
    if CHECK_LAUNCHES and launches != expected:
        raise AssertionError(f"train CLI: launches {launches} != {expected}")
    return rec, ckpt


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase_test_cli(ckpt, lc_launches, l_launches, lc_device_ms, lc_ms, l_ms):
    print(f"phase 25: the port's test CLI in process on phase 24's "
          f"checkpoint: the flagship config (LC) and the L-only inference "
          f"config, --synthetic-data, {CLI_STEPS} samples each", flush=True)
    from unibev_tpu_torch.tools import test_UniBEV
    rec = {}
    runs = (("LC", FLAGSHIP_CONFIG, lc_launches, 0, lc_ms),
            ("L", L_CONFIG, l_launches, -1, l_ms))
    for mode, cfg, per_sample, want_overflow, phase_ms in runs:
        out = os.path.join(CLI_DIR, f"results_{mode}.json")
        logs = _Records()
        logging.getLogger("unibev_tpu_torch").addHandler(logs)
        try:
            summary, launches = _counts_during(lambda: test_UniBEV.run(
                test_UniBEV.parse_args([
                    cfg, ckpt, "--synthetic-data", "--max-samples",
                    str(CLI_STEPS), "--out", out])))
        finally:
            logging.getLogger("unibev_tpu_torch").removeHandler(logs)
        with open(out) as f:
            results = json.load(f)
        expected = _times(CLI_STEPS, per_sample)
        dropped = [m for m in logs.messages if "checkpoint subtree" in m]
        r = dict(ms_per_sample=summary["ms_per_sample"],
                 predict_ms=summary["predict_ms"], wait_ms=summary["wait_ms"],
                 sca_overflow=summary["sca_overflow"], launches=launches,
                 expected_launches=expected, results=len(results),
                 dropped_subtrees=dropped)
        rec[mode] = r
        print(f"  {mode}: {summary['ms_per_sample']:.2f} ms/sample through "
              f"the CLI (predict, copies and read-back "
              f"{summary['predict_ms']:.2f}, "
              f"loader wait {summary['wait_ms']:.2f}; medians after the "
              f"first); phase {13 if mode == 'LC' else 14}'s predict alone "
              f"{phase_ms:.2f}; sca_overflow {summary['sca_overflow']}; "
              f"launches {launches} (expected {CLI_STEPS} x phase "
              f"{13 if mode == 'LC' else 14}'s: {expected}); checkpoint "
              f"subtrees dropped: {dropped}", flush=True)
        finite = all(np.isfinite(x).all() for res in results
                     for x in (np.asarray(res["boxes_3d"]),
                               np.asarray(res["scores_3d"])))
        if (len(results) != CLI_STEPS or not finite
                or any(list(res) != ["sample_idx", "boxes_3d", "scores_3d",
                                     "labels_3d", "valid"]
                       or np.asarray(res["boxes_3d"]).shape != (300, 9)
                       for res in results)):
            raise AssertionError(f"test CLI {mode}: bad results in {out}")
        if summary["sca_overflow"] != want_overflow:
            raise AssertionError(f"test CLI {mode}: sca_overflow "
                                 f"{summary['sca_overflow']} != "
                                 f"{want_overflow}")
        if CHECK_LAUNCHES and launches != expected:
            raise AssertionError(f"test CLI {mode}: launches {launches} != "
                                 f"{expected}")
        if mode == "L" and not any("'img_backbone" in m for m in dropped):
            raise AssertionError("the L config kept the camera keys: "
                                 f"{dropped}")
    rec["LC"]["idle_share_estimate"] = 1.0 - lc_device_ms / rec["LC"][
        "ms_per_sample"]
    print(f"  LC idle share ~{rec['LC']['idle_share_estimate']:.3f} (phase "
          f"15's {lc_device_ms:.3f} ms of device a forward over the CLI's "
          f"ms/sample)", flush=True)
    return rec


DISK_SAMPLES = 3        # phase 26's tree: 3 train samples, the first 2 for val
DISK_CAMS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK",
             "CAM_BACK_LEFT", "CAM_BACK_RIGHT")
DISK_POINTS = 34000     # about one nuScenes LiDAR sweep


def write_disk_tree(root, rng):
    """A nuScenes-shaped tree on disk (mmdet3d v0.18 info pickles with
    absolute paths): per sample a float32 (34000, 5) LiDAR .bin and six
    1600x900 JPEGs (cameras 60 degrees apart, f = 1266 px, the synthetic
    batch's geometry), and 8 annotated boxes.  Returns the train and val
    info files."""
    import pickle

    from PIL import Image
    os.makedirs(root, exist_ok=True)
    K = [[1266.0, 0.0, 800.0], [0.0, 1266.0, 450.0], [0.0, 0.0, 1.0]]
    names = ("car", "pedestrian", "truck", "barrier")
    infos = []
    for s in range(DISK_SAMPLES):
        pts = np.empty((DISK_POINTS, 5), np.float32)
        pts[:, :2] = rng.uniform(-54, 54, (DISK_POINTS, 2))
        pts[:, 2] = rng.uniform(-3, 1, DISK_POINTS)
        pts[:, 3:] = rng.rand(DISK_POINTS, 2)
        lidar = os.path.join(root, f"lidar_{s}.bin")
        pts.tofile(lidar)
        cams = {}
        for n, cam in enumerate(DISK_CAMS):
            th = n * np.pi / 3
            # camera axes in the LiDAR frame: x right, y down, z forward
            fwd = np.array([np.cos(th), np.sin(th), 0.0])
            right = np.array([np.sin(th), -np.cos(th), 0.0])
            down = np.array([0.0, 0.0, -1.0])
            path = os.path.join(root, f"{cam}_{s}.jpg")
            Image.fromarray(rng.randint(0, 256, (900, 1600, 3), np.uint8)
                            ).save(path, quality=90)
            cams[cam] = dict(data_path=path,
                             sensor2lidar_rotation=np.stack(
                                 [right, down, fwd], 1),
                             sensor2lidar_translation=np.zeros(3),
                             cam_intrinsic=np.array(K))
        boxes = np.zeros((8, 7), np.float32)
        boxes[:, :2] = rng.uniform(-40, 40, (8, 2))
        boxes[:, 2] = rng.uniform(-2, 0, 8)
        boxes[:, 3:6] = rng.uniform(0.5, 4.0, (8, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, 8)
        infos.append(dict(
            token=f"sample{s}", lidar_path=lidar, sweeps=[],
            timestamp=1_000_000 * (s + 1), scene_token="scene0", cams=cams,
            gt_boxes=boxes,
            gt_names=np.array([names[i % 4] for i in range(8)]),
            gt_velocity=rng.randn(8, 2).astype(np.float32),
            num_lidar_pts=rng.randint(1, 50, 8),
            valid_flag=np.ones(8, bool)))
    paths = []
    for split, rows in (("train", infos), ("val", infos[:2])):
        paths.append(os.path.join(root, f"infos_{split}.pkl"))
        with open(paths[-1], "wb") as f:
            pickle.dump(dict(infos=rows, metadata=dict(version="fake")), f)
    return paths


def phase_disk_cli(ckpt, step_launches, lc_launches):
    print(f"phase 26: both CLIs on a nuScenes-shaped tree on disk (the "
          f"flagship config's own pipelines: 6 JPEGs at 1600x900 and a "
          f"{DISK_POINTS}-point sweep a sample, PIL decoding): 2 train "
          f"steps, then the test CLI with the metric on 2 val samples",
          flush=True)
    from unibev_tpu_torch.tools import test_UniBEV, train_UniBEV
    t0 = time.perf_counter()
    train_info, val_info = write_disk_tree(os.path.join(CLI_DIR, "nusc"),
                                           np.random.RandomState(0))
    write_s = time.perf_counter() - t0
    work_dir = os.path.join(CLI_DIR, "disk_train")
    t0 = time.perf_counter()
    rc, launches = _counts_during(lambda: train_UniBEV.main([
        FLAGSHIP_CONFIG, "--max-steps", "2", "--work-dir", work_dir,
        "--no-validate", "--cfg-options", f"data.train.ann_file={train_info}",
        "log_config.interval=1"]))
    train_s = time.perf_counter() - t0
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    expected = _times(2, step_launches)
    print(f"  tree written in {write_s:.1f} s; train CLI {train_s:.1f} s: "
          f"steps (loss, data_time s, time s) "
          f"{_step_rows(steps)}; "
          f"launches {launches} (expected 2 x phase 18's)", flush=True)
    if rc != 0 or len(steps) != 2 or not all(np.isfinite(st["loss"])
                                              for st in steps):
        raise AssertionError(f"train CLI on disk: rc {rc}, steps {steps}")
    if CHECK_LAUNCHES and launches != expected:
        raise AssertionError(f"train CLI on disk: launches {launches} != "
                             f"{expected}")
    # the train loader alone on these files (2 workers, as the config asks;
    # 2 epochs of the 3 samples): the host's rate for real data
    from unibev_tpu_torch.data.loader import DataLoader
    from unibev_tpu_torch.registry import DATASETS
    from unibev_tpu_torch.tools.cli_common import load_config
    cfg = load_config(FLAGSHIP_CONFIG, [f"data.train.ann_file={train_info}"])
    loader = DataLoader(DATASETS.build(dict(cfg.data["train"])), batch_size=1,
                        num_workers=2, pin_memory=True)
    gaps = []
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in loader:
            gaps.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
    loader_s = float(np.median(gaps[1:]))
    print(f"  the train loader alone on the files (2 workers): "
          f"{loader_s:.3f} s a batch (median of {len(gaps) - 1} after the "
          f"first; gaps {[round(g, 3) for g in gaps]})", flush=True)
    out = os.path.join(CLI_DIR, "results_disk.json")
    summary, launches = _counts_during(lambda: test_UniBEV.run(
        test_UniBEV.parse_args([FLAGSHIP_CONFIG, ckpt, "--out", out,
                                "--cfg-options",
                                f"data.test.ann_file={val_info}"])))
    expected = _times(2, lc_launches)
    metrics = summary["metrics"]
    print(f"  test CLI: {summary['ms_per_sample']:.2f} ms/sample (predict "
          f"{summary['predict_ms']:.2f}, loader wait "
          f"{summary['wait_ms']:.2f}); "
          f"sca_overflow {summary['sca_overflow']}; launches {launches} "
          f"(expected 2 x phase 13's); metrics {metrics}", flush=True)
    if (len(summary["results"]) != 2 or summary["sca_overflow"] != 0
            or metrics is None or not np.isfinite(metrics["mAP"])):
        raise AssertionError(f"test CLI on disk: {summary['sca_overflow']}, "
                             f"{metrics}, {len(summary['results'])} results")
    if CHECK_LAUNCHES and launches != expected:
        raise AssertionError(f"test CLI on disk: launches {launches} != "
                             f"{expected}")
    return dict(write_s=write_s, train_s=train_s, steps=steps,
                loader_s_per_batch=loader_s, loader_gaps=gaps,
                ms_per_sample=summary["ms_per_sample"],
                predict_ms=summary["predict_ms"], wait_ms=summary["wait_ms"],
                metrics=metrics)


def compare_only():
    """``--compare``: the flagship paths' walls and device profiles alone
    (phases 5-6, 9-10, 13-15, 18-19), with the launch counts printed but
    not held to this file's tables.  To compare two checkouts with one
    harness, copy this file into the other's root and run both in one call,
    in the order A B B A."""
    global CHECK_LAUNCHES
    CHECK_LAUNCHES = False
    print(f"package {os.path.join(ROOT, 'unibev_tpu_torch')}", flush=True)
    model, batch, c = phase_flagship()
    phase_profile(model, batch, c["ms_per_sample"])
    del model, batch
    model, batch, lc = phase_flagship_lc()
    l_batch, l_only = phase_flagship_l(model, batch)
    phase_profile_lidar(model, batch, l_batch, lc["ms_per_sample"],
                        l_only["ms_per_sample"])
    del model, batch, l_batch
    for lidar in (False, True):
        torch.cuda.empty_cache()
        model, opt, sched, batch, tgen, step = phase_flagship_train(
            lidar=lidar)
        phase_profile_train(model, opt, sched, batch, tgen,
                            1000 * step["s_per_step"], lidar=lidar)
        del model, opt, sched, batch, tgen
    return 0


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv == ["--compare"]:
        _build.lib()
        return compare_only()
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    print("phase 1: card, versions, kernel build", flush=True)
    print(f"  {smi}; torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; kernels built and loaded "
          f"in {build_s:.1f} s", flush=True)
    ptxas = ptxas_report()
    for f in ptxas:
        print(f"  ptxas {f['name'][:110]}: {f.get('used')}; {f.get('frame')}",
              flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    msda = phase_msda(gen)
    dcn, dcn_cols = phase_dcn(gen)
    tiny = phase_tiny()
    model, batch, flagship = phase_flagship()
    prof = phase_profile(model, batch, flagship["ms_per_sample"])
    del model, batch
    torch.cuda.empty_cache()
    bwd = phase_backward(gen)
    tiny_train = phase_tiny_train()
    model, opt, sched, batch, tgen, train = phase_flagship_train()
    prof_train = phase_profile_train(model, opt, sched, batch, tgen,
                                     1000 * train["s_per_step"])
    del model, opt, sched, batch, tgen
    torch.cuda.empty_cache()
    k6, k7, lidar_counts = phase_sparse(gen)
    tiny_lc = phase_tiny_lc()
    model, batch, lc = phase_flagship_lc()
    l_batch, l_only = phase_flagship_l(model, batch)
    prof_lc, prof_l = phase_profile_lidar(model, batch, l_batch,
                                          lc["ms_per_sample"],
                                          l_only["ms_per_sample"])
    del model, batch, l_batch
    torch.cuda.empty_cache()
    k8, k9, k7_bwd = phase_sparse_backward(gen)
    tiny_lc_train = phase_tiny_train(lidar=True)
    model, opt, sched, batch, tgen, lc_train = phase_flagship_train(lidar=True)
    prof_lc_train = phase_profile_train(model, opt, sched, batch, tgen,
                                        1000 * lc_train["s_per_step"],
                                        lidar=True)
    lc_steps = lc_train["launches"]
    del model, opt, sched, batch, tgen
    torch.cuda.empty_cache()
    msda_d16, msda_bwd_d16 = phase_msda_d16(gen)
    tiny_variants = phase_tiny_variants()
    configs = phase_configs()
    cat_train = phase_cat_train()
    train_cli, ckpt = phase_train_cli(lc_steps,
                                      prof_lc_train["device_ms_total"])
    test_cli = phase_test_cli(ckpt, lc["launches"], l_only["launches"],
                              prof_lc["device_ms_total"], lc["ms_per_sample"],
                              l_only["ms_per_sample"])
    disk_cli = phase_disk_cli(ckpt, lc_steps, lc["launches"])
    shutil.rmtree(CLI_DIR, ignore_errors=True)

    sparse_cu = "unibev_tpu_torch/csrc/sparse_conv.cu"
    kernels = [
        kernel_entry("msda_fwd", "unibev_tpu_torch/csrc/msda.cu",
                     "unibev_tpu/ops/msda_pallas.py:213",
                     lc["launches"]["msda_fwd"], msda),
        kernel_entry("dcn_fwd", "unibev_tpu_torch/csrc/deform_conv.cu",
                     "unibev_tpu/ops/deform_conv.py:442",
                     lc["launches"]["dcn_fwd"], dcn),
        kernel_entry("dcn_im2col", "unibev_tpu_torch/csrc/deform_conv.cu",
                     "unibev_tpu/ops/deform_conv.py:323",
                     lc_steps["dcn_im2col"], dcn_cols),
        kernel_entry("msda_bwd", "unibev_tpu_torch/csrc/msda.cu",
                     "unibev_tpu/ops/msda_pallas.py:106",
                     lc_steps["msda_bwd"], bwd["msda_bwd"]),
        kernel_entry("dcn_bwd", "unibev_tpu_torch/csrc/deform_conv.cu",
                     "unibev_tpu/ops/deform_conv.py:323",
                     lc_steps["dcn_bwd"], bwd["dcn_bwd"]),
        kernel_entry("scatter_add_rows", "unibev_tpu_torch/csrc/scatter.cu",
                     "unibev_tpu/ops/scatter_pallas.py:60",
                     lc_steps.get("scatter_add_rows", 0),
                     bwd["scatter_add_rows"],
                     library_ms=bwd["scatter_add_rows"]["library_ms"]),
        kernel_entry("sparse_nbr", sparse_cu, "unibev_tpu/ops/sparse_conv.py:170",
                     lc["launches"]["sparse_nbr"], k6),
        kernel_entry("sparse_conv", sparse_cu, "unibev_tpu/ops/sparse_conv.py:312",
                     lc["launches"]["sparse_conv"], k7),
        kernel_entry("sparse_inv_nbr", sparse_cu,
                     "unibev_tpu/ops/sparse_conv.py:701",
                     lc_steps["sparse_inv_nbr"], k8),
        kernel_entry("sparse_conv_wgrad", sparse_cu,
                     "unibev_tpu/ops/sparse_conv.py:358",
                     lc_steps["sparse_conv_wgrad"], k9),
    ]
    # K1 and K3 also carry cat_128's D = 16 sites (phase 20), summed over
    # their launches in one cat_128 LC forward / step
    for entry, rec in ((kernels[0], msda_d16), (kernels[3], msda_bwd_d16)):
        entry["max_abs_err"] = max(entry["max_abs_err"], rec["max_abs_err"])
        entry.update(d16_ms=rec["ms"], d16_plain_ms=rec["plain_ms"],
                     d16_bound_ms=rec["bound_ms"])
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count())
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
                       build_s=build_s, ptxas=ptxas, msda=msda, dcn_fwd=dcn,
                       dcn_im2col=dcn_cols,
                       tiny=tiny,
                       flagship=flagship, profile=prof, backward=bwd,
                       tiny_train=tiny_train, train=train,
                       profile_train=prof_train, sparse_nbr=k6,
                       sparse_conv=k7, lidar_counts=lidar_counts,
                       tiny_lc=tiny_lc, lc=lc, l_only=l_only,
                       profile_lc=prof_lc, profile_l=prof_l,
                       sparse_inv_nbr=k8, sparse_conv_wgrad=k9,
                       sparse_conv_bwd=k7_bwd, tiny_lc_train=tiny_lc_train,
                       lc_train=lc_train, profile_lc_train=prof_lc_train,
                       msda_d16=msda_d16, msda_bwd_d16=msda_bwd_d16,
                       tiny_variants=tiny_variants, configs=configs,
                       cat_train=cat_train, train_cli=train_cli,
                       test_cli=test_cli, disk_cli=disk_cli,
                       kernels=kernels, device=device), f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
