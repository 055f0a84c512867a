#!/usr/bin/env python3
"""Smoke run of the PyTorch port (unibev_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare   # K10-K12, phases 5-6, 9-10, 13-15, 18-19
    python3 chip_smoke.py --radar-dp  # phases 24 and 27-31 alone
    python3 chip_smoke.py --ddp-cards 4   # phase 31 on 4 cards (NCCL)

Builds the hand-written CUDA kernels from unibev_tpu_torch/csrc with nvcc,
then, each phase printing one line (or a few) and raising on any failure:

  1. the card (nvidia-smi name and power limit), torch / CUDA versions, the
     kernel build time, and what ``nvcc -Xptxas -v`` reports for K1, K2
     (dcn_fwd), the im2col, K3, K4, K6, K7, K8, K9, K10, K11, K12 and
     K13 (registers, static shared memory, stack, spills);
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
  3b. kernel K13 (frozen_bn_act: a frozen BN with its ReLU, and the
     residual add or the downsample branch's BN) against its plain version
     at every site of a ResNet-101 forward on 6 images of 928x1600 (the
     stem, each stage's bn1 / bn2, bn3 with the identity, bn3 with the
     downsample branch), bf16, and f32 at stage 3; its time (CUDA events
     and the profiler's device time, over input copies that pass the L2),
     the host's time a call, the plain version's time and the bound per
     site and summed over the forward's 100 launches;
  4. the tiny camera-only model: CUDA with the kernels against the CPU with
     the plain versions, same weights and inputs;
  5. full-width flagship camera-only predict in bf16 (6 cameras at
     928x1600): launch counts of one forward (12 K1, 26 K2, 100 K13), ms
     per sample (median of 10
     synchronized iterations after 3 warm-ups), peak memory, SCA overflow,
     finite boxes, and the device operations (kernels, copies, fills) of
     one ``img_backbone`` forward by category, from the profiler;
  6. a torch.profiler breakdown of one forward by kernel (every profile
     phase drains the card, opens its trace with spin kernels that absorb
     the kernels the profiler drops at a session's start, and holds each
     hand kernel's traced launches to its ``_build.launches`` count);
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
     step against the counts derived from the call sites (190 K13: 100 and
     the recompute of the 30 checkpointed bottlenecks), s/step (median of
     10 after 3 warm-ups), peak memory, finite losses and grad norm, SCA
     overflow, frozen parameters bit-identical after the steps;
 10. a torch.profiler breakdown of one train step by kernel;
 11. kernel K10 (voxelize) against its plain version on the synthetic
     batch's 300k points and on the same cloud with 1,000 voxels of 20
     points each (over the 10-point cap, among more voxels than the
     120,000 kept): coords, mask, counts and caps equal, the means within
     1e-6; kernel K11 (active_set) against its plain versions at the 5
     table calls of one forward (build_table at res 0, the four
     downsample_with_table calls: the active sets of the strided convs):
     bitmaps, counts, coords, masks and overflows equal, the rank -> row
     maps on the live ranks; each with its time (CUDA events and the
     profiler's device time), its plain version's and its bound; the
     device time of the 5 table calls; and the sparse-conv kernels against
     their plain versions at every flagship LiDAR site, on the active sets
     and rulebooks of the voxelized synthetic batch: K6 sparse_nbr exactly
     (its time beside K6_BEFORE_MS, the kernel over a dense int32 table),
     K7 sparse_conv in f32 (TF32 off) and bf16, with both times and their
     ratio;
 12. the tiny LC model in LC and L mode: CUDA with the kernels against the
     CPU with the plain versions, same weights and inputs;
 13. full-width flagship LC predict in bf16 (6 cameras at 928x1600 and 300k
     points): launch counts of one forward (18 K1, 26 K2, 1 K10, 5 K11,
     8 K6, 21 K7, 100 K13, no im2col), ms
     per sample (median of 10 after 3 warm-ups), peak memory, SCA overflow,
     finite boxes, and, printed, the voxels before the cap and each strided
     conv's overflow;
 14. L predict on the same model (the batch without images): launch counts
     (12 K1, 0 K2, 1 K10, 5 K11, 8 K6, 21 K7) and ms per sample;
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
     one step against the counts derived from the call sites (K10 1, K11
     5, K6 8, K7 41, K8 4, K9 21 and K1-K4 with the LiDAR MSDA sites),
     s/step (median of 10 after 3 warm-ups) with the flags each step
     drew, peak memory, finite losses, SCA overflow on the camera-live
     steps, frozen parameters bit-identical, LiDAR running statistics
     moved;
 19. a torch.profiler breakdown of one LC train step by kernel;
 19b. the sync check on phase 18's model: one ``head.loss`` (the
     assignment on K12 included) under ``torch.cuda.set_sync_debug_mode(
     "error")``, so that any call that makes the host wait for the card
     fails the run (launches: 1 K12); one whole LC train step under
     "warn", printing its synchronizing calls and where each comes from
     (none may come from the loss); one ``val_step``, the val workflow's
     loss (launches: phase 13's and 1 K12);
 19c. kernel K12 (lsa, the head's Hungarian assignment) against its plain
     version, col4row equal, on (a) the problems of the loss of a forward
     of phase 18's model (L x B = 6 problems of 64 gt rows, 40 valid, x
     900 queries), (b) 6 x 140 x 900 with 0, 1, 35, 139 and 140 valid
     rows and one mask with holes, (c) integer costs in [0, 8), full of
     ties; each problem's total cost against scipy's optimum (relative
     1e-6); K12's time (CUDA events and the profiler's device time), the
     plain version's, the host route the assigner took before K12 (the
     costs copied to the host, scipy per problem, the result copied back;
     host clock), the bound, and each problem's Dijkstra steps (the plain
     version's count) with the device time a step of the longest chain,
     beside K12_BEFORE_MS (the device time of K12's first design); and K12
     captured in a ``torch.cuda.CUDAGraph`` on case (a), replayed on
     fresh costs and masks, each replay equal to the plain version;
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
     overflow 0, a finite mAP);
 27. K5 at the radar pillar scatter of the full-width RC model (the
     synthetic batch's 2048 radar points voxelized into 0.6 m pillars:
     40,000 rows x 64, ~2,000 live, into the 180 x 180 canvas; the masked
     rows hold data and must be skipped), exactly against its plain
     version in f32 and bf16; its time beside the plain version's,
     ``index_add_`` (with the JAX package's drop row) and the bound; and
     K10 at the radar voxelizer against its plain version, on the batch's
     cloud and with 30 points in one pillar (over the 20-point cap), as in
     phase 11;
 28. the tiny RC model in RC, R and C mode (launching K5 where radar
     runs) and one train step, CUDA against the CPU as phases 12 and 17;
 29. full-width RC predict (the flagship with radar in LiDAR's slot,
     ``flagship_model_cfg(use_lidar=False, use_radar=True)``) in RC, R and
     C mode from one model: launch counts (RC 18 K1, 26 K2, 1 K10, 1 K5;
     R 12 K1, 1 K10, 1 K5; C phase 5's), ms per sample (median of 10
     after 3 warm-ups), peak memory, SCA overflow 0, and profiles of RC
     and R;
 30. the full-width RC train step with modality dropout: launch counts
     per step (18 K1, 52 K2, 26 im2col, 18 K3, 26 K4, 1 K10, 1 K5),
     s/step,
     peak memory, the profile;
 31. data parallel: (a) the train CLI under ``torch.distributed.run
     --standalone --nproc_per_node=1 --launcher pytorch`` (NCCL,
     DistributedDataParallel at world size 1: NCCL cannot put two ranks on
     one card) on the flagship config with --synthetic-data for 4 steps:
     launches per step equal phase 18's, the first step's loss within
     1e-6 of phase 24's and its gradient norm within 1e-3 (the later
     steps' losses are printed, not held: they drift with the atomics'
     order through AdamW), and the test CLI under the same launcher on its
     checkpoint; (b) two gloo ranks spawned on the
     card with the tiny LC model at B=1 each against one process at B=2
     (``unibev_tpu_torch/tools/ddp_check.py``): losses, first-step
     gradients and LiDAR running statistics within 1e-3, parameters and
     buffers bit-identical across the ranks, equal modality flags, and the
     eval gather of 3 samples giving the one process's metric.
     ``--ddp-cards N`` runs this phase alone on N cards of one host: (a)
     with one NCCL rank a card (a global batch of N, launches per step
     held), (b) with N NCCL ranks against one process at B=N.

Each kernel's entry in the line before the last gives its launches on the
path it serves (K1, K2, K6, K7, K10, K11, K13: one LC predict; the im2col,
K3, K4, K8, K9, K12: one LC train step; K5: one RC predict), its time
summed over that path's call sites (CUDA events; K5 at the radar pillar
scatter, phase 27; K1 and K3 also ``d16_*``, summed over cat_128's D = 16
launches; K13 also ``device_ms``, the profiler's; K10
also ``radar_*``, its launch a forward at the radar site; K12 on the
loss's problems, phase 19c's case a), its plain
version's, the least time the card could take for the same work
(``bound_ms``: the larger of the bytes each call must move over 3.35 TB/s
and its operations over 989 TFLOP/s, the H100 SXM's HBM3 and dense bf16
peaks, K12's float32 compares and adds over 67 TFLOP/s, counting the
rulebook entries and Dijkstra steps this run's data holds), and the time
of one PyTorch call computing the same function where there is one
(``library_ms``, K5's float32 ``index_add_`` at the radar site; K12's is
the scipy route on the host, phase 19c; the port calls neither).
The last line is {"ok": true, "device": {...}}.  The numbers also go to
chip_smoke.json in the output directory beside this script.  Exits non-zero
without a CUDA device or when any phase fails.
"""

from __future__ import annotations

import copy
import itertools
import json
import logging
import os
import shutil
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from unibev_tpu_torch.flagship import (PC_RANGE,  # noqa: E402
                                       RADAR_POINTS, VOXEL_SIZE,
                                       build_flagship, build_model,
                                       build_model_from_config,
                                       flagship_model_cfg, synthetic_batch,
                                       tiny_batch, tiny_model_cfg)
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
# K12's device time a call (the profiler) on phase 19c's cases before its
# redesign (the first design: 256 threads, three barriers a row; the
# parent checkout's phase 19c on an NVIDIA H100 80GB HBM3 at 700.00 W, as
# PERF.md section 6 records it): phase 19c prints each case's new time
# beside it.
K12_BEFORE_MS = {"a loss": 0.0629, "b 140 rows": 0.2188,
                 "c integer ties": 10.1172}

# The least time of a call: the larger of its bytes (each input read once,
# each output written once) over the H100 SXM's HBM3 rate and its
# operations over the H100 SXM's dense bf16 tensor-core peak; the card's
# name and power limit are printed beside every number.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
# the H100 SXM's float32 peak outside the tensor cores: K12's compares and
# adds
FP32_OPS_PER_S = 67e12
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


def device_by_kernel(fn, iters):
    """{kernel: device time per call in ms} of ``fn``: the profiler's kernel
    times over ``iters`` calls, warmed up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prime_trace()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1000 / iters
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and PRIMER_KERNEL not in e.key}


def device_ms(fn, iters):
    """Device time per call of ``fn`` in ms: the profiler's kernel time over
    ``iters`` calls, warmed up (unlike ``cuda_ms``, never the host's)."""
    return sum(device_by_kernel(fn, iters).values())


def host_us(fn, calls=200):
    """The host's time of one call of ``fn`` in us: a host clock over
    ``calls`` back-to-back calls with no synchronize among them, over
    ``calls`` (the card drained before, warmed up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def new_rec():
    """A kernel's record: times summed over its call sites (calls x ms per
    call), worst error, the least times, and the sites."""
    return dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, bound_ms=0.0,
                bytes_ms=0.0, ops_ms=0.0, sites={})


def add_site(rec, site, calls, ms, plain, err, nbytes, ops,
             ops_per_s=BF16_OPS_PER_S, **extra):
    """Add one call site (``calls`` launches per path, ``ms`` / ``plain``
    per call) with its bytes and operations (at ``ops_per_s``) to ``rec``;
    returns the site's least time per call in ms."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
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
                          "sparse_inv_nbr", "sparse_wgrad", "fill_words",
                          "scan_tiles", "mark_points", "slot_points",
                          "emit_voxels", "mark_rows", "mark_sites",
                          "build_rows", "emit_sites", "lsa_kernel",
                          "frozen_bn_act")):
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


def frozen_bn_sites(depth=101, images=6, height=928, width=1600):
    """K13's call sites in one forward of the caffe-style ResNet at
    ``depth`` on ``images`` images of height x width: (name, images,
    launches, form, C, H, W).  The stem's BN at half the image after
    conv1; in each stage bn1 and bn2 of every block (form a), bn3 with the
    identity (b) and the first block's bn3 with the downsample branch (c),
    at the stage's resolution (the stride sits on the first 1x1)."""
    from unibev_tpu_torch.models.backbones.resnet import ARCH_SETTINGS
    h, w = height // 2, width // 2
    sites = [("stem", images, 1, "a", 64, h, w)]
    h, w = -(-h // 2), -(-w // 2)                       # the max pooling
    for s, n in enumerate(ARCH_SETTINGS[depth]):
        planes = 64 * 2 ** s
        if s:
            h, w = -(-h // 2), -(-w // 2)
        sites += [(f"stage{s + 1} bn1/bn2", images, 2 * n, "a", planes, h, w),
                  (f"stage{s + 1} bn3", images, n - 1, "b", 4 * planes, h, w),
                  (f"stage{s + 1} bn3+down", images, 1, "c", 4 * planes, h,
                   w)]
    return [s for s in sites if s[2]]


def frozen_bn_launches(depth=101, train=False, frozen_stages=1):
    """K13's launches in one ResNet forward at ``depth``: one a frozen BN
    site but the downsample BNs (the stem's, then three a bottleneck); a
    train step adds the checkpoint recompute of every bottleneck past the
    frozen stages."""
    from unibev_tpu_torch.models.backbones.resnet import ARCH_SETTINGS
    blocks = ARCH_SETTINGS[depth]
    return 1 + 3 * sum(blocks) + (3 * sum(blocks[frozen_stages:]) if train
                                  else 0)


def _random_bn(C, gen, dtype):
    """A FrozenBatchNorm on the card with buffers away from the identity
    (weight, bias and mean normal, var in [0.5, 2])."""
    from unibev_tpu_torch.models.backbones.resnet import FrozenBatchNorm
    bn = FrozenBatchNorm(C).cuda()
    for name in ("weight", "bias", "running_mean"):
        getattr(bn, name).copy_(torch.randn(C, device="cuda", generator=gen))
    bn.running_var.copy_(0.5 + 1.5 * torch.rand(C, device="cuda",
                                                generator=gen))
    return bn.to(dtype)


def phase_frozen_bn(gen):
    # imported here: --compare also runs against checkouts that predate it
    from unibev_tpu_torch.ops.frozen_bn import (frozen_bn_act,
                                                frozen_bn_act_reference)
    print("phase 3b: K13 frozen_bn_act (a frozen BN with its ReLU and "
          "residual add, one pass) vs frozen_bn_act_reference at ResNet-101's "
          "sites, 6 images of 928x1600, bf16 (f32 checked at stage 3)",
          flush=True)
    rec = new_rec()
    rec["device_ms"] = 0.0
    for name, images, calls, form, C, H, W in frozen_bn_sites():
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and not name.startswith("stage3"):
                continue
            shape = (images, C, H, W)
            # bf16 (timed): enough copies of the inputs to pass the 50 MB L2
            # several times over, taken in turn, so that a timed call reads
            # what the calls before it did not
            per_call = (2 + (form != "a")) * images * C * H * W * 2
            n = (max(1, -(-256 * 2 ** 20 // per_call))
                 if dtype == torch.bfloat16 else 1)
            cases = []
            for _ in range(n):
                x = torch.randn(shape, device="cuda", generator=gen).to(
                    dtype).contiguous(memory_format=torch.channels_last)
                kw = {}
                if form == "b":
                    kw["residual"] = torch.randn_like(x)
                if form == "c":
                    kw = dict(down=torch.randn_like(x),
                              down_bn=_random_bn(C, gen, dtype))
                cases.append((x, _random_bn(C, gen, dtype), kw))
            x, bn, kw = cases[0]
            rel = 1e-6 if dtype == torch.float32 else 2 ** -8
            tag = f"{name} ({form}, C {C}, {H}x{W}) {str(dtype)[6:]}"
            err = check(tag, frozen_bn_act(x, bn, **kw),
                        frozen_bn_act_reference(x, bn, **kw), rel)
            if dtype == torch.float32:
                continue
            turn = itertools.cycle(cases)

            def one():
                x, bn, kw = next(turn)
                return frozen_bn_act(x, bn, **kw)
            ms = cuda_ms(one, 40)
            dev = device_ms(one, 40)
            host = host_us(one)
            plain = cuda_ms(lambda: frozen_bn_act_reference(x, bn, **kw), 5)
            nbytes = (2 + (form != "a")) * x.numel() * x.element_size() \
                + 4 * C * 2 * (1 + (form == "c"))
            bound = add_site(rec, name, calls, ms, plain, err, nbytes, 0,
                             device_ms=dev, host_us=host)
            rec["device_ms"] += calls * dev
            print(f"  {name}: {calls} launches a forward; kernel {ms:.4f} ms "
                  f"(device {dev:.4f}; host {host:.1f} us a call), plain "
                  f"{plain:.4f} ms, bound {bound:.4f} ms (bytes): "
                  f"{100 * bound / dev:.1f}% of it by device time", flush=True)
            del cases, x, bn, kw
    ratio_line("K13 over one ResNet-101 forward", rec)
    share = 100 * rec["bound_ms"] / rec["device_ms"]
    print(f"  device time over the forward's 100 launches "
          f"{rec['device_ms']:.4f} ms: {share:.1f}% of the bound", flush=True)
    torch.cuda.empty_cache()
    return rec


def backbone_kernels(model, batch):
    """The device operations (kernels, copies, fills) of one ``img_backbone``
    forward of ``model`` on ``batch``'s images, counted by the profiler
    (primers left out): (total, by category)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    img = batch["img"]
    B, N, H, W, _ = img.shape
    x = img.reshape(B * N, H, W, 3).permute(0, 3, 1, 2).to(model.compute_dtype)
    with torch.inference_mode():
        model.img_backbone(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prime_trace()
            model.img_backbone(x)
            torch.cuda.synchronize()
    by = Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and PRIMER_KERNEL not in e.key:
            by[_category(e.key)] += e.count
    total = sum(by.values())
    print(f"  img_backbone: {total} device operations a forward {dict(by)}",
          flush=True)
    return total, dict(by)


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
    rec["backbone_ops"], rec["backbone_ops_by_category"] = backbone_kernels(
        model, batch)
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


# the synthetic flagship batch's samples: the voxelizer runs once a sample
BATCH = 1


def expected_predict_launches(camera=True, lidar=True, radar=False):
    """Kernel launches of one flagship predict, LC, C (``lidar`` False) or
    L (``camera`` False), or of the RC model (``lidar`` False, ``radar``)
    in RC or R mode, from the call sites: K1 once per MSDA call (the
    decoder's, the camera encoder's and the LiDAR encoder's, which the
    radar map feeds as the LiDAR map does), K2 (dcn_fwd) once per DCN
    call, the voxelizer K10 once per sample of the LiDAR or radar cloud
    (``UniBEV._voxelize``), the sparse encoder's K11 once per table (its
    res-0 table and the active sets of its strided convs), K6 and K7, and
    the radar pillar scatter's K5 once, and K13 once a frozen BN site of
    the ResNet-101 (``frozen_bn_launches``).  No im2col: only the DCN
    backward builds columns."""
    sites = [s for s in MSDA_SITES if camera or s[0] == "decoder_ca"]
    sites += LIDAR_MSDA_SITES if lidar or radar else []
    out = dict(msda_fwd=sum(s[1] for s in sites))
    if camera:
        out["dcn_fwd"] = sum(s[1] for s in DCN_SITES)
        out["frozen_bn_act"] = frozen_bn_launches()
    if lidar or radar:
        out["voxelize"] = BATCH
    if lidar:
        nbr, convs, strided = _sparse_launches()
        out.update(sparse_nbr=nbr, sparse_conv=convs, active_set=1 + strided)
    if radar:
        out["scatter_add_rows"] = 1
    return out


def expected_train_launches(lidar=False, radar=False):
    """Kernel launches of one flagship train step, C or (``lidar``) LC, from
    the call sites: K1 and K3 once per MSDA call; K2 (dcn_fwd) once per DCN
    call and once more in the backbone's checkpoint recompute; the im2col
    (the columns for d_weight) and K4 once per DCN backward; no K5 (K3 and
    K4 add into their tables themselves).  LC adds the LiDAR encoder's MSDA
    sites and the sparse encoder: one K6 rulebook per resolution and per
    strided conv, K7 once per conv forward and once per conv but conv_input
    backward (d_feats; the voxel features need none), K8 once per strided
    conv, K9 once per conv.  The RC model (``radar``) adds the LiDAR
    encoder's MSDA sites and one K5, the pillar scatter's forward (its
    backward is a gather, no kernel).  Both add K10 once per sample, and
    LC K11 once per table: the forward's, which the backward reuses.  Every
    step's loss assigns all its decoder layers' problems in one K12 call.
    K13 runs once a frozen BN site and once more in the recompute of every
    bottleneck past the frozen stage (its backward is plain PyTorch)."""
    sites = MSDA_SITES + (LIDAR_MSDA_SITES if lidar or radar else [])
    msda = sum(s[1] for s in sites)
    dcn = sum(s[1] for s in DCN_SITES)
    out = dict(msda_fwd=msda, msda_bwd=msda, dcn_fwd=2 * dcn, dcn_im2col=dcn,
               dcn_bwd=dcn, lsa=1,
               frozen_bn_act=frozen_bn_launches(train=True))
    if lidar or radar:
        out["voxelize"] = BATCH
    if lidar:
        nbr, convs, strided = _sparse_launches()
        out.update(sparse_nbr=nbr, sparse_conv=2 * convs - 1,
                   sparse_inv_nbr=strided, sparse_conv_wgrad=convs,
                   active_set=1 + strided)
    if radar:
        out["scatter_add_rows"] = 1
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


def phase_tiny_train(lidar=False, radar=False):
    """One tiny train step on CUDA against the CPU: C, LC (``lidar``) or RC
    (``radar``, phase 28's step, which prints its own header)."""
    if lidar:
        print("phase 17: tiny LC train step, CUDA kernels vs CPU plain "
              "versions, the LiDAR modules in train mode", flush=True)
    elif not radar:
        print("phase 8: tiny C-only train step, CUDA kernels vs CPU plain "
              "versions", flush=True)
    cpu_model = build_model(tiny_model_cfg(use_lidar=lidar, use_radar=radar),
                            "cpu", seed=0, train=True).eval()
    for name in LIDAR_MODULES if lidar or radar else ():
        if hasattr(cpu_model, name):
            getattr(cpu_model, name).train()   # batch statistics; no draws
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    start = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    stats0 = lidar_running_stats(cpu_model)
    batch = tiny_batch(np.random.RandomState(0), R=TINY_RADAR if radar else 0)
    gpu_batch = {k: v.to("cuda") for k, v in batch.items()}
    metrics = []
    for model, b in ((cpu_model, batch), (gpu_model, gpu_batch)):
        opt, sched = make_optimizer(model)
        before = dict(_build.launches)
        metrics.append(train_step(model, opt, sched, b))
        torch.cuda.synchronize()
    launched = {k for k, v in _build.launches.items() if v > before.get(k, 0)}
    need = {"msda_bwd", "dcn_bwd", "lsa"}
    if lidar:
        need |= {"sparse_nbr", "sparse_conv", "sparse_inv_nbr",
                 "sparse_conv_wgrad", "active_set"}
    if lidar or radar:
        need.add("voxelize")
    if radar:
        need.add("scatter_add_rows")
    if not need <= launched:
        raise AssertionError(f"the tiny CUDA step launched only {launched}")
    cpu_p = dict(cpu_model.named_parameters())
    gpu_p = {n: p.detach().cpu() for n, p in gpu_model.named_parameters()}
    grads = {n: p.grad for n, p in cpu_p.items() if p.grad is not None}
    rec = dict(
        losses=check_each("losses", metrics[1], metrics[0], TINY_REL_TOL),
        grads=check_each("gradients", {n: gpu_model.get_parameter(n).grad
                                       for n in grads}, grads, TINY_REL_TOL))
    if lidar or radar:
        want = lidar_running_stats(cpu_model)
        if not want or any(torch.equal(want[n], stats0[n]) for n in want):
            raise AssertionError("a LiDAR running statistic did not move")
        rec["running_stats"] = check_each(
            "LiDAR / radar branch running statistics",
            lidar_running_stats(gpu_model), want, TINY_REL_TOL)
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


def res0_grid(points, voxel=(VOXEL_SIZE, PC_RANGE, VOXEL_GRID),
              sparse_shape=SPARSE_SHAPE, capacity=CAPACITIES[0]):
    """(the voxelizer's result, the res-0 active set) of one cloud, every
    point live, as the LiDAR branch builds them (batch 1)."""
    mask = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    vox = voxelize_and_encode(points, mask, *voxel, capacity)
    zero = torch.zeros_like(vox.coords[:, :1])
    coords = torch.where(vox.mask[:, None], torch.cat([zero, vox.coords], 1), -1)
    return vox, SparseGrid(coords.contiguous(), vox.mask, sparse_shape, 1)


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
    vox, grid = res0_grid(points, voxel, sparse_shape, capacities[0])
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


def hold_voxelizer(rec, site, calls, points, mask, args):
    """K10 against its plain version on one cloud: coords, mask, counts and
    caps equal, the means within 1e-6 of the largest; both timed (CUDA
    events; the host's time a call; the kernel's profiler device time and
    its scan's alone).  ``calls`` per path (0 for a cloud of no path).
    Returns the plain version's result."""
    # imported here: --compare runs this script in checkouts without it
    from unibev_tpu_torch.ops.voxelize import voxelize_and_encode_reference
    run = lambda: voxelize_and_encode(points, mask, *args)  # noqa: E731
    plain = lambda: voxelize_and_encode_reference(  # noqa: E731
        points, mask, *args)
    got, want = run(), plain()
    for k in ("coords", "mask", "num_points", "num_voxels", "num_distinct"):
        g, w = getattr(got, k), getattr(want, k)
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"K10 {site}: {k} differs from the plain "
                                 f"version")
    err = check(f"K10 {site} feats", got.feats, want.feats, 1e-6)
    ms, plain_ms = cuda_ms(run, 20), cuda_ms(plain, 5)
    host = host_us(run)
    kernels = device_by_kernel(run, 10)
    dev = sum(kernels.values())
    scan = sum(v for k, v in kernels.items() if "scan_tiles" in k)
    P, F = points.shape
    distinct, kept = int(want.num_distinct), int(want.num_voxels)
    most = int(want.num_points.max())
    # the points and their mask in; each voxel's float32 feature, int32
    # coords, mask and count, and the two scalars out
    nbytes = (4 * F + 1) * P + (4 * F + 17) * args[3] + 12
    bound = add_site(rec, site, calls, ms, plain_ms, err, nbytes, 0,
                     device_ms=dev, scan_device_ms=scan, host_us=host,
                     points=P, distinct=distinct, kept=kept,
                     at_point_cap=int((want.num_points == args[4]).sum()))
    print(f"  K10 {site}: {P} points, {distinct} voxels, {kept} kept, at most "
          f"{most} points a voxel, equal; kernel {ms:.4f} ms by events, host "
          f"{host:.1f} us a call, device {dev:.4f} (scan {scan:.4f}), plain "
          f"{plain_ms:.4f} ms, bound {bound:.4f} ms", flush=True)
    return want


def clustered_cloud(points, gen, clusters=1000, per=20, z_cells=10):
    """The flagship cloud with its first ``clusters * per`` points moved,
    ``per`` each, into ``clusters`` voxels of the lowest ``z_cells`` layers
    (within 0.3 of a voxel of its centre): kept voxels over the 10-point
    cap, among more distinct voxels than the 120,000 kept."""
    pts = points.clone()
    cells = torch.stack([torch.randint(0, n, (clusters,), device="cuda",
                                       generator=gen)
                         for n in (VOXEL_GRID[0], VOXEL_GRID[1], z_cells)], 1)
    size = torch.tensor(VOXEL_SIZE, device="cuda")
    centre = torch.tensor(PC_RANGE[:3], device="cuda") + (cells + 0.5) * size
    jitter = (torch.rand(clusters, per, 3, device="cuda", generator=gen)
              - 0.5) * 0.6 * size
    pts[:clusters * per, :3] = (centre[:, None] + jitter).reshape(-1, 3)
    return pts


def hold_tables(grid):
    """K11 against its plain versions at the 5 table calls of one
    SparseEncoder forward (``build_table`` at res 0, the three strided
    convs' and ``conv_out``'s ``downsample_with_table``): bitmaps, counts,
    coords, masks and overflows equal, and the rank -> row maps on the live
    ranks; each call timed (CUDA events, the host's time a call, device
    time and its scan's alone).  The next call reads the kernel's grid."""
    from unibev_tpu_torch.ops.sparse_conv import (
        build_table_reference, downsample_with_table_reference)
    rec = new_rec()
    names = ["table0"] + [f"down{i}" for i in range(len(DOWN_PADDINGS))] \
        + ["conv_out"]
    for name, conv in zip(names, [None] + STRIDED_CONVS):
        V = grid.coords.shape[0]
        if conv is None:
            args = (grid,)
            run, plain = build_table, build_table_reference
            tab, want = run(grid), plain(grid)
            live, out_rows, over = int(grid.mask.sum()), 0, 0
        else:
            kernel, stride, padding, capacity = conv
            out_shape = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                              zip(grid.shape, padding, kernel, stride))
            args = (grid, kernel, stride, padding, out_shape, capacity)
            run, plain = downsample_with_table, downsample_with_table_reference
            (co, mo, tab, over), (wco, wmo, want, wover) = run(*args), plain(*args)
            if not (torch.equal(co, wco) and torch.equal(mo, wmo)
                    and over.dtype == wover.dtype and torch.equal(over, wover)):
                raise AssertionError(f"K11 {name}: coords, mask or overflow "
                                     f"differ from the plain version")
            live, out_rows, over = capacity, capacity, int(over)
            grid = SparseGrid(co, mo, out_shape, grid.batch)
        words = tab.bits.numel()
        if not (torch.equal(tab.bits, want.bits)
                and torch.equal(tab.base, want.base)
                and tab.rows.shape == want.rows.shape
                and torch.equal(tab.rows[:live], want.rows[:live])):
            raise AssertionError(f"K11 {name}: the table differs from the "
                                 f"plain version's")
        ms = cuda_ms(lambda: run(*args), 20)
        host = host_us(lambda: run(*args))
        kernels = device_by_kernel(lambda: run(*args), 10)
        dev = sum(kernels.values())
        scan = sum(v for k, v in kernels.items() if "scan_tiles" in k)
        plain_ms = cuda_ms(lambda: plain(*args), 5)
        plain_dev = device_ms(lambda: plain(*args), 5)
        # coords and mask in; bits, counts and the map out, and a
        # downsample's coords, mask and overflow
        nbytes = 17 * V + 8 * words + 4 * tab.rows.numel() + 17 * out_rows \
            + (8 if conv else 0)
        bound = add_site(rec, name, 1, ms, plain_ms, 0.0, nbytes, 0,
                         device_ms=dev, scan_device_ms=scan, host_us=host,
                         plain_device_ms=plain_dev, rows_in=V, words=words,
                         overflow=over)
        print(f"  K11 {name}: {V} rows in, {words} words, overflow {over}, "
              f"equal; kernel {ms:.4f} ms by events, host {host:.1f} us a "
              f"call, device {dev:.4f} (scan {scan:.4f}), plain "
              f"{plain_ms:.4f} ms (device {plain_dev:.4f}), bound "
              f"{bound:.4f} ms", flush=True)
    for key in ("device_ms", "scan_device_ms", "host_us", "plain_device_ms"):
        rec[key] = sum(v[key] for v in rec["sites"].values())
    ratio_line(f"K11 over the 5 launches of one forward (device "
               f"{rec['device_ms']:.4f} ms, scan {rec['scan_device_ms']:.4f}, "
               f"host {rec['host_us']:.1f} us; plain versions' device "
               f"{rec['plain_device_ms']:.4f} ms)", rec)
    return rec


def phase_sparse(gen):
    print("phase 11: K10 voxelize, K11 active_set, K6 sparse_nbr and K7 "
          "sparse_conv vs their plain versions at the flagship LiDAR sites",
          flush=True)
    points = synthetic_batch(np.random.RandomState(0), device="cuda")["points"][0]
    mask = torch.ones(points.shape[0], dtype=torch.bool, device="cuda")
    vox_args = (VOXEL_SIZE, PC_RANGE, VOXEL_GRID, CAPACITIES[0], 10)
    rec10 = new_rec()
    hold_voxelizer(rec10, "lidar", 1, points, mask, vox_args)
    want = hold_voxelizer(rec10, "lidar_clustered", 0,
                          clustered_cloud(points, gen), mask, vox_args)
    if not (int(want.num_distinct) > CAPACITIES[0]
            and int(want.num_points.max()) == 10
            and int((want.num_points == 10).sum()) >= 900):
        raise AssertionError("the clustered cloud must hold kept voxels over "
                             "the point cap and more voxels than the cap")
    k6, k7, _, counts = lidar_sites(points)
    grid = counts.pop("grid")
    print(f"  voxelized synthetic batch: {counts}", flush=True)
    rec11 = hold_tables(grid)
    counts["tables_device_ms"] = device_ms(lambda: _tables_of_a_forward(grid),
                                           5)
    counts["tables_ms"] = cuda_ms(lambda: _tables_of_a_forward(grid), 5)
    print(f"  the compact tables of one forward (build_table and 4 "
          f"downsample_with_table, K11): device "
          f"{counts['tables_device_ms']:.4f} ms, events "
          f"{counts['tables_ms']:.4f} ms", flush=True)
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
    return rec6, rec7, rec10, rec11, counts


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
        if not {"sparse_nbr", "sparse_conv", "msda_fwd", "voxelize",
                "active_set"} <= launched:
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
    if "lsa_kernel" in n:
        return "K12 lsa"
    if "frozen_bn_act" in n:
        return "K13 frozen_bn_act"
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
    # the bitmap kernels shared by K10 and K11 carry the kernel's number as
    # their first template argument
    if any(k in n for k in ("<10>", "<10,", "mark_points", "slot_points",
                            "emit_voxels")):
        return "K10 voxelize"
    if any(k in n for k in ("<11>", "<11,", "mark_rows", "mark_sites",
                            "build_rows", "emit_sites")):
        return "K11 active_set"
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

# The __global__ functions each hand kernel's C entry point launches a fixed
# number of times a call (alternative name fragments, count): the profile
# phases hold the traced kernels to _build.launches.  K10 launches its
# fill, mark, scan, slot and emit; K11 its fill, marks rows or sites, scans
# and builds rows or emits sites.
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
    "frozen_bn_act": ((("frozen_bn_act_kernel",), 1),),
}

# In a long-lived process the profiler dropped the first device kernels of
# a session: a trace that began with the voxelizer showed 2, then 5, then
# none of K10's 8 kernels as the run went on (phases 15, 22 and 29), with
# the card drained and the host idle 50 ms after the start, and device_ms
# lost ~20% of 20 K12 calls late in the run; a fresh process, even after
# 300 sessions, kept them all (a study since removed; benchmark/trace.py
# holds each of its traces to the launches).
# Late in a run it has also kept 0 of the 256 primers, and once 8 of a
# forward's 18 msda_fwd launches, the last hand kernels of a predict.  So
# every trace opens with TRACE_PRIMERS spin kernels (torch.cuda._sleep's
# PRIMER_KERNEL) and closes with TRACE_TRAILERS more after the run's
# synchronize and TRACE_SETTLE_S of host time, none of which any reading
# counts; the profile phases print how many of each were kept and how many
# of the trace's recorded kernel launches have no device record.
TRACE_PRIMERS = 1024
TRACE_TRAILERS = 256
TRACE_SETTLE_S = 0.05
PRIMER_KERNEL = "spin_kernel"
# a profile whose hand kernels differ from _build.launches in a trace that
# lost device records, or every primer or every trailer (trace_losses), is
# traced again, at most this many times in all; one that differs in a trace
# that lost none of these, or in every attempt, is a fault
TRACE_ATTEMPTS = 3
# the profiles whose traced hand kernels differ from _build.launches: the
# run goes on and fails at its end
TRACE_FAULTS = []


def raise_trace_faults():
    if TRACE_FAULTS:
        raise AssertionError(f"{len(TRACE_FAULTS)} profiles traced other hand "
                             f"kernel counts than they launched (traced, "
                             f"expected): {TRACE_FAULTS}")


def prime_trace(n=TRACE_PRIMERS):
    """Open a trace with ``n`` short spin kernels."""
    for _ in range(n):
        torch.cuda._sleep(1000)


def _traced(run, primers=TRACE_PRIMERS, trailers=TRACE_TRAILERS):
    """(profiler, host ms of ``run`` and its synchronize): ``run`` traced on
    the CPU and the card, the card drained first, the run's kernels queued
    behind ``primers`` spin kernels and followed, once the run has drained,
    by ``trailers`` more and TRACE_SETTLE_S of host time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prime_trace(primers)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1000
        prime_trace(trailers)
        torch.cuda.synchronize()
        time.sleep(TRACE_SETTLE_S)
    return prof, traced_ms


def _launch_ranges(idx):
    """'a-b, c' for the sorted ints ``idx``."""
    out, start = [], None
    for i, k in enumerate(idx):
        if start is None:
            start = k
        if i + 1 == len(idx) or idx[i + 1] != k + 1:
            out.append(f"{start}-{k}" if k != start else f"{k}")
            start = None
    return ", ".join(out)


def trace_losses(prof):
    """What a trace kept at its edges and lost within: primers and trailers
    kept (the spin kernels before the run's first other device event and
    after its last), the kernel launches the host recorded, and those of
    them with no device record, as ranges of launch order with the host ms
    of the first and last of them from the first launch."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    device = sorted((e for e in events if e.device_type() == DeviceType.CUDA
                     and not e.name().startswith("Optimizer.")),
                    key=lambda e: e.start_ns())
    work = [i for i, e in enumerate(device) if PRIMER_KERNEL not in e.name()]
    spins = [i for i, e in enumerate(device) if PRIMER_KERNEL in e.name()]
    lead = sum(1 for i in spins if not work or i < work[0])
    trail = sum(1 for i in spins if work and i > work[-1])
    device_corr = {e.correlation_id() for e in device}
    launches = sorted((e for e in events if e.device_type() == DeviceType.CPU
                       and ("LaunchKernel" in e.name()
                            or "LaunchCooperativeKernel" in e.name())),
                      key=lambda e: e.start_ns())
    lost = [i for i, e in enumerate(launches)
            if e.correlation_id() not in device_corr]
    where = ""
    if lost:
        t0 = launches[0].start_ns()
        where = (f" (launches {_launch_ranges(lost)} of 0-{len(launches) - 1}"
                 f", host {(launches[lost[0]].start_ns() - t0) / 1e6:.3f}-"
                 f"{(launches[lost[-1]].start_ns() - t0) / 1e6:.3f} ms of "
                 f"{(launches[-1].start_ns() - t0) / 1e6:.3f})")
    return dict(primers=lead, trailers=trail, launches=len(launches),
                lost=len(lost), where=where)


def profiled_counts(events, launched):
    """{kernel: (traced __global__ launches, expected)} of every hand kernel
    in ``launched`` ({kernel: _build.launches in the traced run}), from the
    profiler's device ``events``, by PROFILED_PER_CALL."""
    out = {}
    for key, calls in launched.items():
        for names, per in PROFILED_PER_CALL[key]:
            got = sum(e.count for e in events
                      if any(f in e.key for f in names))
            out[f"{key} {'|'.join(names)}"] = (got, per * calls)
    return out


def _profile(run, wall_ms):
    """Device time by kernel category of one traced ``run``, its idle share
    against ``wall_ms``, and the host's time in the traced run: its wall
    less the time the host spent in WAIT_CALLS (tracing adds to it).  Each
    hand kernel's traced launches must equal its _build.launches count; a
    trace that differs and shows a loss (trace_losses) is taken again, up
    to TRACE_ATTEMPTS traces in all."""
    from torch.autograd import DeviceType
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        before = dict(_build.launches)
        prof, traced_ms = _traced(run)
        launched = {k: v - before.get(k, 0) for k, v in _build.launches.items()
                    if v != before.get(k, 0)}
        # kernels only: the optimizer's record_function range ("Optimizer.
        # step#AdamW.step") also shows as a device event and would count its
        # kernels twice
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        events = [e for e in device if e.self_device_time_total > 0
                  and not e.key.startswith("Optimizer.")
                  and PRIMER_KERNEL not in e.key]
        if not events:
            raise AssertionError("the profiler recorded no device kernels")
        counts = profiled_counts(events, launched)
        wrong = {k: v for k, v in counts.items() if v[0] != v[1]}
        kept = trace_losses(prof)
        print(f"  trace {attempt}: primers kept {kept['primers']} of "
              f"{TRACE_PRIMERS}, trailers {kept['trailers']} of "
              f"{TRACE_TRAILERS}; {kept['lost']} of {kept['launches']} "
              f"recorded kernel launches without a device record"
              f"{kept['where']}", flush=True)
        if not wrong:
            break
        print(f"  hand kernels traced / launched DIFFER: {wrong}", flush=True)
        # a cut that took every primer or every trailer may reach the run
        lossy = kept["lost"] or not kept["primers"] or not kept["trailers"]
        if not lossy or attempt == TRACE_ATTEMPTS:
            TRACE_FAULTS.append(wrong)
            break
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
    waits = sorted((e for e in prof.events() if e.name in WAIT_CALLS),
                   key=lambda e: e.time_range.start)
    # the last is the trailers' synchronize, after the traced run
    if waits and waits[-1].name == "cudaDeviceSynchronize":
        waits = waits[:-1]
    wait_ms = sum(e.self_cpu_time_total for e in waits) / 1000
    # cudaMemcpyAsync is also every copy on the card, which waits for nothing
    by_call = {}
    for e in waits:
        by_call[e.name] = by_call.get(e.name, 0) + 1
    print(f"  host: traced run {traced_ms:.3f} ms, of which {wait_ms:.3f} ms "
          f"in {len(waits)} waiting calls {by_call}; host "
          f"time {traced_ms - wait_ms:.3f} ms", flush=True)
    print(f"  hand kernels traced / launched: "
          f"{ {k: v[0] for k, v in counts.items()} }"
          + (f"; DIFFER: {wrong}" if wrong else ", all equal"), flush=True)
    top = [dict(name=e.key[:120], calls=e.count,
                device_ms=e.self_device_time_total / 1000) for e in events[:30]]
    return dict(device_ms_total=total_ms, idle_share=idle, by_category=by_cat,
                traced_ms=traced_ms, wait_ms=wait_ms,
                host_ms=traced_ms - wait_ms, top=top,
                waiting_calls=len(waits),
                waiting_calls_by_call=by_call,
                launches=launched,
                traced_launches={k: v[0] for k, v in counts.items()},
                primers_traced=kept["primers"],
                trailers_traced=kept["trailers"],
                trace_attempts=attempt,
                launches_without_device_record=kept["lost"])


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


def _since(before):
    """{kernel: launches} counted since the snapshot ``before``."""
    return {k: v - before.get(k, 0) for k, v in _build.launches.items()
            if v != before.get(k, 0)}


def _gt(batch):
    return batch["gt_bboxes"], batch["gt_labels"], batch["gt_valid"]


def phase_sync_check(model, opt, sched, batch, gen):
    """Phase 19b on phase 18's model: the loss under the error mode of
    torch.cuda.set_sync_debug_mode, a whole step under its warn mode, and
    one val_step's launches."""
    from unibev_tpu_torch.parallel.train_state import (compute_autocast,
                                                       val_step)
    print("phase 19b: the sync check on phase 18's model: one head.loss (the "
          "assignment on K12) with every synchronizing CUDA call an error, "
          "one LC train step with each one a warning, one val_step",
          flush=True)
    head = model.pts_bbox_head
    with compute_autocast(model):
        preds = model(batch, gen)
    torch.cuda.synchronize()
    before = dict(_build.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with compute_autocast(model):
            losses = head.loss(preds, *_gt(batch))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    loss_launches = _since(before)
    finite = all(bool(torch.isfinite(v).all()) for v in losses.values())
    print(f"  head.loss under 'error': no synchronizing call; launches "
          f"{loss_launches}; {len(losses)} finite losses {finite}", flush=True)
    if loss_launches != {"lsa": 1} or not finite:
        raise AssertionError(f"head.loss: launches {loss_launches}, finite "
                             f"{finite}")
    del preds, losses

    package = os.path.join(ROOT, "unibev_tpu_torch") + os.sep
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        """Where a synchronizing call came from: the call itself and the
        innermost frame of the port's package above it."""
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(package)]
        via = (f"{os.path.relpath(ours[-1].filename, ROOT)}:{ours[-1].lineno}"
               if ours else "-")
        where = (os.path.relpath(filename, ROOT)
                 if filename.startswith(ROOT) else filename)
        sites.append((f"{where}:{lineno}", via, str(message)[:80]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            train_step(model, opt, sched, batch, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [s for s in sites if "synchroniz" in s[2]]
    print(f"  one LC train step under 'warn': {len(syncs)} synchronizing "
          f"calls", flush=True)
    for (where, via, _), n in Counter(syncs).most_common():
        print(f"    {n} x {where} (the port's frame: {via})", flush=True)
    assigning = [s for s in syncs
                 if "core/bbox" in s[1] or "heads/unibev_head" in s[1]]
    if assigning:
        raise AssertionError(f"the step's loss synchronized: {assigning}")

    before = dict(_build.launches)
    val = val_step(model, batch)
    torch.cuda.synchronize()
    val_launches = _since(before)
    want = dict(expected_predict_launches(), lsa=1)
    print(f"  val_step: loss {float(val['loss']):.4f}; launches "
          f"{val_launches} (expected phase 13's and 1 lsa: {want})",
          flush=True)
    if CHECK_LAUNCHES and val_launches != want:
        raise AssertionError(f"val_step launches {val_launches} != {want}")
    return dict(loss_launches=loss_launches, step_syncs=len(syncs),
                step_sync_sites=[dict(where=w, via=v, calls=n)
                                 for (w, v, _), n in Counter(syncs).items()],
                val_launches=val_launches)


# K12's cases beside the loss's (phase 19c): 6 problems of 140 gt rows (the
# data path's max_gt) x 900 queries, valid counts 0, 1, 35, 139 and 140
# (packed) and one mask with holes; float costs, or integers in [0, 8)
LSA_COUNTS = (0, 1, 35, 139, 140)
LSA_G, LSA_Q = 140, 900


def lsa_cases(head, preds, batch):
    """{case: (cost (P, G, Q) float32, valid (P, G) bool)} on the card: (a)
    the problems of ``head.loss`` on ``preds`` (its L * B problems), (b)
    and (c) the synthetic ones above."""
    cls, bbox = preds["all_cls_scores"], preds["all_bbox_preds"]
    L, B, Q = cls.shape[:3]

    def rep(x):
        return x[None].expand(L, *x.shape).reshape(L * B, *x.shape[1:])

    gt_b, gt_l, gt_valid = _gt(batch)
    cases = {"a loss": (head.assigner.costs(
        bbox.float().reshape(L * B, Q, -1), cls.float().reshape(L * B, Q, -1),
        rep(gt_b.float()), rep(gt_l.long())),
        rep(gt_valid).bool().contiguous())}
    rng = np.random.RandomState(0)
    valid = np.zeros((len(LSA_COUNTS) + 1, LSA_G), bool)
    for p, n in enumerate(LSA_COUNTS):
        valid[p, :n] = True
    valid[-1] = rng.rand(LSA_G) < 0.3
    shape = (len(valid), LSA_G, LSA_Q)
    for name, cost in (("b 140 rows", rng.rand(*shape) * 4),
                       ("c integer ties", rng.randint(0, 8, shape))):
        cases[name] = (torch.tensor(cost, dtype=torch.float32, device="cuda"),
                       torch.tensor(valid, device="cuda"))
    return cases


def _scipy_route(cost, valid):
    """The assignment as the assigner solved it before K12: the (P, Q, G)
    costs copied to the host, scipy on each problem's valid columns, gt_inds
    and the positive mask copied back."""
    from scipy.optimize import linear_sum_assignment as scipy_lsa
    c = cost.cpu().numpy()
    v = valid.cpu().numpy()
    gt_inds = np.zeros(c.shape[:2], np.int64)
    pos = np.zeros(c.shape[:2], bool)
    for i in range(c.shape[0]):
        rows = np.flatnonzero(v[i])
        if rows.size:
            r, q = scipy_lsa(c[i][:, rows].T)
            gt_inds[i, q] = rows[r]
            pos[i, q] = True
    return (torch.from_numpy(gt_inds).to(cost.device),
            torch.from_numpy(pos).to(cost.device))


def phase_lsa(model, batch, gen):
    """Phase 19c: K12 against its plain version on the loss's problems and
    on cases (b) and (c)."""
    from scipy.optimize import linear_sum_assignment as scipy_lsa
    from unibev_tpu_torch.core.bbox.lsa import (linear_sum_assignment,
                                                solve_with_steps)
    from unibev_tpu_torch.parallel.train_state import compute_autocast
    print("phase 19c: kernel K12 lsa vs its plain version (col4row equal), "
          "on the loss of phase 18's model (L x B = 6 problems, 64 gt rows of "
          "which 40 valid, 900 queries), on 6 x 140 x 900 with 0, 1, 35, 139, "
          "140 valid rows and one mask with holes, and on integer costs in "
          "[0, 8)", flush=True)
    with torch.no_grad(), compute_autocast(model):
        preds = model(batch, gen)
    cases = lsa_cases(model.pts_bbox_head, preds, batch)
    del preds
    rec, out = new_rec(), {}
    for name, (cost, valid) in cases.items():
        P, G, Q = cost.shape
        got = linear_sum_assignment(cost, valid)
        want, steps = solve_with_steps(cost, valid)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        # the optimum, independently of both versions (ties leave the
        # assignment itself free)
        c, v = cost.cpu().double().numpy(), valid.cpu().numpy()
        g = got.cpu().numpy()
        worst = 0.0
        for p in range(P):
            rows = np.flatnonzero(v[p])
            if rows.size == 0:
                continue
            cols = g[p, rows]
            if (cols < 0).any() or len(set(cols.tolist())) != rows.size:
                raise AssertionError(f"K12 {name}: problem {p} assigns "
                                     f"columns {cols}")
            r, q = scipy_lsa(c[p][rows])
            best = c[p][rows[r], q].sum()
            worst = max(worst, abs(c[p][rows, cols].sum() - best)
                        / max(abs(best), 1e-30))
        kernel_ms = cuda_ms(lambda: linear_sum_assignment(cost, valid), 50)
        kernel_dev = device_ms(lambda: linear_sum_assignment(cost, valid), 20)
        plain_ms = cuda_ms(lambda: solve_with_steps(cost, valid), 1)
        cost_qg = cost.transpose(1, 2).contiguous()
        _scipy_route(cost_qg, valid)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _scipy_route(cost_qg, valid)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1000)
        scipy_ms = float(np.median(times))
        rows = int(valid.sum())
        # the valid rows' costs, the mask, col4row; a few compares and adds
        # per column and Dijkstra step
        nbytes = rows * Q * 4 + P * G + P * G * 4
        ops = 4 * Q * int(steps.sum())
        longest = int(steps.max())
        site = dict(ms=kernel_ms, device_ms=kernel_dev, plain_ms=plain_ms,
                    library_ms=scipy_ms, differ=differ, cost_rel_err=worst,
                    valid_rows=rows, steps=steps.tolist(),
                    longest_chain=longest,
                    device_ms_per_step=kernel_dev / max(longest, 1))
        if name.startswith("a"):
            bound = add_site(rec, name, 1, kernel_ms, plain_ms, 0.0, nbytes,
                             ops, ops_per_s=FP32_OPS_PER_S,
                             **{k: v for k, v in site.items()
                                if k not in ("ms", "plain_ms")})
            rec.update(device_ms=kernel_dev, library_ms=scipy_ms)
        else:
            bound = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
            site["bound_ms"] = bound
        out[name] = site
        print(f"  {name}: {P} x {G} x {Q}, {rows} valid rows: col4row "
              f"differs in {differ}; total cost against scipy's optimum "
              f"{worst:.1e}; K12 {kernel_ms:.4f} ms (device {kernel_dev:.4f}),"
              f" plain {plain_ms:.2f} ms, the scipy route on the host "
              f"{scipy_ms:.3f} ms, bound {bound:.5f} ms (bytes); Dijkstra "
              f"steps per problem {steps.tolist()}: "
              f"{site['device_ms_per_step'] * 1e3:.3f} us of device a step of "
              f"the longest chain; device before its redesign "
              f"{K12_BEFORE_MS[name]:.4f} ms", flush=True)
        if differ or not worst <= 1e-6:
            raise AssertionError(f"K12 {name}: col4row differs in {differ}, "
                                 f"total cost off by {worst}")
    rec["cases"] = out
    rec["graph_replays"] = lsa_graph_replay(*cases["a loss"])
    return rec


def lsa_graph_replay(cost, valid, replays=3):
    """K12 captured in a CUDA graph on ``cost`` / ``valid`` after a warm-up,
    then replayed on fresh costs (uniform in the same range) and masks
    copied into the captured inputs: each replay's col4row equals the plain
    version's, so the kernel resets its state inside the launch.  Returns
    the replays' mismatches."""
    from unibev_tpu_torch.core.bbox.lsa import (linear_sum_assignment,
                                                linear_sum_assignment_plain)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        linear_sum_assignment(cost, valid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(_build.launches)
    with torch.cuda.graph(graph):
        got = linear_sum_assignment(cost, valid)
    if _since(before) != {"lsa": 1}:
        raise AssertionError(f"K12 graph capture launched {_since(before)}")
    lo, hi = float(cost.min()), float(cost.max())
    rng = np.random.RandomState(1)
    differ = []
    for _ in range(replays):
        cost.copy_(torch.tensor(rng.uniform(lo, hi, cost.shape),
                                dtype=torch.float32))
        valid.copy_(torch.tensor(rng.rand(*valid.shape) < 0.6))
        graph.replay()
        torch.cuda.synchronize()
        want = linear_sum_assignment_plain(cost.cpu(), valid.cpu())
        differ.append(int((got.cpu() != want).sum()))
    print(f"  a loss in a CUDA graph, {replays} replays on fresh costs and "
          f"masks: col4row differs in {differ}", flush=True)
    if any(differ):
        raise AssertionError(f"K12 graph replays differ: {differ}")
    return differ


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
    forward = {"msda_fwd", "dcn_fwd", "sparse_nbr", "sparse_conv", "voxelize",
               "active_set"}
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
        if not forward | backward | {"lsa"} <= launched:
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


# The radar branch (phases 27-30): the tiny RC model's radar points (as
# tests/test_radar.py draws them) and the full-width RC model's pillar grid
TINY_RADAR = 64
RC_CFG = flagship_model_cfg(use_lidar=False, use_radar=True)
RADAR_LAYER = RC_CFG["radar_voxel_layer"]
RADAR_GRID = (180, 180, 1)
RADAR_CELLS = RADAR_GRID[0] * RADAR_GRID[1]
RADAR_C = RC_CFG["radar_voxel_encoder"]["feat_channels"][-1]
# the modes of an RC model: the batch keys each drops
RC_MODES = {"RC": ("points", "points_mask"),
            "R": ("img", "points", "points_mask"),
            "C": ("radar", "radar_mask", "points", "points_mask")}


def _rc_batch(device="cuda"):
    """The synthetic flagship batch with its radar cloud and without LiDAR."""
    batch = synthetic_batch(np.random.RandomState(0), device=device,
                            R=RADAR_POINTS)
    return {k: v for k, v in batch.items() if k not in RC_MODES["RC"]}


def phase_radar_scatter(gen):
    print("phase 27: K5 at the radar pillar scatter of the full-width RC "
          "model (40,000 pillar rows x 64 into the 180 x 180 canvas) vs its "
          "plain version, index_add_ and the bound; K10 at the radar "
          "voxelizer vs its plain version", flush=True)
    batch = _rc_batch()
    radar, mask = batch["radar"][0], batch["radar_mask"][0]
    args = (RADAR_LAYER["voxel_size"], RADAR_LAYER["point_cloud_range"],
            RADAR_GRID, RADAR_LAYER["max_voxels"][1],
            RADAR_LAYER["max_num_points"])
    res = voxelize_and_encode(radar, mask, *args)
    rows = res.mask.numel()
    live = int(res.mask.sum())
    coords = res.coords.long()
    # PointPillarsScatter's rows (batch 0): (y * W + x), masked ones at
    # RADAR_CELLS, one past the canvas
    idx = torch.where(res.mask, coords[:, 1] * RADAR_GRID[0] + coords[:, 2],
                      RADAR_CELLS).int()
    rec = new_rec()
    for dtype in (torch.float32, torch.bfloat16):
        contrib = torch.randn(rows, RADAR_C, device="cuda",
                              generator=gen).to(dtype)
        # masked rows hold data here: the scatter must skip them, not add
        # them anywhere
        got = scatter_add_rows(idx, contrib, RADAR_CELLS)
        want = scatter_add_rows_reference(idx, contrib, RADAR_CELLS)
        if not torch.equal(got, want):
            raise AssertionError(f"K5 at the radar site ({dtype}) is not "
                                 f"exact: {(got - want).abs().max().item()}")
        print(f"  {str(dtype)[6:]}: exact against the plain version ({live} "
              f"live pillars of {rows} rows, each at its own cell)", flush=True)
    contrib = torch.where(res.mask[:, None], contrib, 0)     # as the PFN gives
    run = lambda: scatter_add_rows(idx, contrib, RADAR_CELLS)  # noqa: E731
    plain = lambda: scatter_add_rows_reference(idx, contrib,  # noqa: E731
                                               RADAR_CELLS)
    k5_ms, plain_ms = cuda_ms(run, 50), cuda_ms(plain, 20)
    k5_dev = device_ms(run, 10)
    table = torch.zeros(RADAR_CELLS, RADAR_C, device="cuda")
    into = cuda_ms(lambda: scatter_add_rows(idx, contrib, RADAR_CELLS,
                                            out=table), 50)
    # the library call: index_add_ into a float32 table with the JAX
    # package's drop row (canvas[:-1]), its inputs converted beforehand
    lib_table = torch.zeros(RADAR_CELLS + 1, RADAR_C, device="cuda")
    idx64, contrib32 = idx.long(), contrib.float()
    lib = cuda_ms(lambda: lib_table.index_add_(0, idx64, contrib32), 50)
    # idx read, the live rows read, the float32 canvas written; one add an
    # element of a live row
    nbytes = 4 * rows + 2 * live * RADAR_C + 4 * RADAR_CELLS * RADAR_C
    bound = add_site(rec, "radar_pillars", 1, k5_ms, plain_ms, 0.0, nbytes,
                     live * RADAR_C, library_ms=lib, device_ms=k5_dev,
                     into_table_ms=into, live=live, rows=rows)
    rec["library_ms"] = lib
    print(f"  K5 bf16 {k5_ms:.4f} ms (device {k5_dev:.4f}; into a given "
          f"table, as index_add_ adds, {into:.4f}), plain {plain_ms:.4f} ms, "
          f"index_add_ {lib:.4f} ms, bound {bound:.4f} ms (bytes)", flush=True)
    # K10 at the radar site: the batch's cloud, and the same with 30 points
    # in one pillar (over the 20-point cap)
    rec["voxelizer"] = new_rec()
    hold_voxelizer(rec["voxelizer"], "radar", 1, radar, mask, args)
    clustered = radar.clone()
    clustered[100:130, :2] = 10.3 + 0.2 * torch.rand(
        30, 2, device="cuda", generator=gen)
    want = hold_voxelizer(rec["voxelizer"], "radar_clustered", 0, clustered,
                          mask, args)
    if int(want.num_points.max()) != args[4]:
        raise AssertionError("the clustered radar cloud must fill a pillar "
                             "past the point cap")
    return rec


def phase_tiny_rc():
    print("phase 28: the tiny RC model in RC, R and C mode and one train "
          "step, CUDA kernels vs CPU plain versions", flush=True)
    cpu_model = build_model(tiny_model_cfg(use_radar=True), "cpu", seed=0)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    full = tiny_batch(np.random.RandomState(0), R=TINY_RADAR)
    need = {"RC": {"msda_fwd", "dcn_fwd", "frozen_bn_act", "scatter_add_rows",
                   "voxelize"},
            "R": {"msda_fwd", "scatter_add_rows", "voxelize"},
            "C": {"msda_fwd", "dcn_fwd", "frozen_bn_act"}}
    rec = {}
    for mode, drop in RC_MODES.items():
        batch = {k: v for k, v in full.items() if k not in drop}
        gpu_batch = {k: v.to("cuda") for k, v in batch.items()}
        before = dict(_build.launches)
        with torch.inference_mode():
            want, got = cpu_model(batch), gpu_model(gpu_batch)
        torch.cuda.synchronize()
        launched = {k for k, v in _build.launches.items()
                    if v > before.get(k, 0)}
        if launched != need[mode]:
            raise AssertionError(f"tiny {mode} on CUDA launched {launched}")
        for k in ("all_cls_scores", "all_bbox_preds"):
            rec[f"{mode} {k}"] = check(f"{mode} {k}", got[k].cpu(), want[k],
                                       TINY_REL_TOL)
        want, got = cpu_model.predict(batch), gpu_model.predict(gpu_batch)
        if not torch.equal(got["labels"].cpu(), want["labels"]):
            raise AssertionError(f"{mode}: decoded labels differ")
        for k in ("scores", "bboxes"):
            rec[f"{mode} {k}"] = check(f"{mode} decoded {k}", got[k].cpu(),
                                       want[k], TINY_REL_TOL)
    rec["train"] = phase_tiny_train(radar=True)
    return rec


def phase_flagship_rc(iters=10):
    print("phase 29: full-width RC predict (radar in LiDAR's slot, 0.6 m "
          "pillars on a 180 x 180 grid) in RC, R and C mode from one RC "
          "model, bf16", flush=True)
    model = build_flagship(device="cuda", dtype=torch.bfloat16, seed=0,
                           use_lidar=False, use_radar=True)
    full = _rc_batch()
    rec = {}
    for mode, drop in RC_MODES.items():
        batch = {k: v for k, v in full.items() if k not in drop}
        rec[mode] = _predict_run(model, batch, iters, expected_predict_launches(
            camera=mode != "R", lidar=False, radar=mode != "C"), mode)
        if mode != "C":
            print(f"  profile of one {mode} forward:", flush=True)
            rec[f"profile_{mode}"] = _profile(lambda: model.predict(batch),
                                              rec[mode]["ms_per_sample"])
    return rec


def phase_flagship_rc_train(iters=10):
    print("phase 30: full-width RC train step (f32 params, bf16 autocast, "
          "modality dropout)", flush=True)
    model = build_flagship(device="cuda", dtype=torch.bfloat16, seed=0,
                           train=True, use_lidar=False, use_radar=True)
    model, opt, sched, batch, gen, rec = _train_run(
        model, _rc_batch(), expected_train_launches(radar=True), iters, 3,
        lidar=True)
    print("  profile of one RC train step:", flush=True)
    rec["profile"] = _profile(lambda: train_step(model, opt, sched, batch, gen),
                              1000 * rec["s_per_step"])
    return rec


def _torchrun(module, *args, nproc=1):
    """``python -m torch.distributed.run --standalone --nproc_per_node=nproc
    -m module args``: (return code, stdout, stderr tail)."""
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", "-m", module, *args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=900)
    return r.returncode, r.stdout, r.stderr[-4000:]


def phase_ddp_cli(step_launches, cli_steps, nproc=1):
    """Phase 31a on ``nproc`` cards (one NCCL rank each); ``cli_steps``,
    phase 24's, are its reference on one card."""
    print(f"phase 31a: the train CLI under torch.distributed.run "
          f"(--standalone --nproc_per_node={nproc}, --launcher pytorch: "
          f"NCCL, DistributedDataParallel) on the flagship config file, "
          f"--synthetic-data, {CLI_STEPS} steps of B={nproc}; the test CLI on "
          f"its checkpoint under the same launcher"
          + (".  NCCL cannot put two ranks on one card and this machine has "
             "one H100: phase 31b puts two gloo ranks on it" if nproc == 1
             else ""), flush=True)
    work = os.path.join(CLI_DIR, "ddp")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # at more ranks, enough synthetic samples for CLI_STEPS global batches
    more = [f"data.train.length={8 * nproc}"] if nproc > 1 else []
    rc, _, err = _torchrun(
        "unibev_tpu_torch.tools.train_UniBEV", FLAGSHIP_CONFIG,
        "--synthetic-data", "--launcher", "pytorch", "--max-steps",
        str(CLI_STEPS), "--work-dir", work, "--cfg-options",
        "log_config.interval=1", *more, nproc=nproc)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"train CLI under torch.distributed.run: rc {rc}"
                             f"\n{err}")
    with open(os.path.join(work, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    logs = "".join(open(os.path.join(work, n)).read()
                   for n in os.listdir(work) if n.endswith(".log"))
    launches = [{k[len("launches/"):]: int(v) for k, v in st.items()
                 if k.startswith("launches/")} for st in steps]
    # at one rank the run is phase 24's; at more, another global batch
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
           for a, b in zip(steps, cli_steps)] if nproc == 1 else [0.0]
    norm_rel = (abs(steps[0]["grad_norm"] - cli_steps[0]["grad_norm"])
                / cli_steps[0]["grad_norm"]) if nproc == 1 else 0.0
    ckpt = os.path.join(work, "checkpoints", f"{CLI_STEPS}.pth")
    keys = list(torch.load(ckpt, map_location="cpu",
                           weights_only=False)["model"])
    out = os.path.join(work, "results.json")
    rc_test, stdout, err_test = _torchrun(
        "unibev_tpu_torch.tools.test_UniBEV", FLAGSHIP_CONFIG, ckpt,
        "--synthetic-data", "--max-samples", str(2 * nproc), "--launcher",
        "pytorch", "--out", out, nproc=nproc)
    results = json.load(open(out)) if rc_test == 0 else []
    rec = dict(wall_s=wall, steps=steps, launches=launches,
               expected_launches=step_launches, loss_rel_err=rel,
               grad_norm_rel_err=norm_rel,
               nccl="process group backend nccl" in logs,
               module_keys=sum(k.startswith("module.") for k in keys),
               test_rc=rc_test, results=len(results),
               s_per_step=float(np.median([st["time"] for st in steps[1:]])))
    print(f"  {len(steps)} steps, {rec['s_per_step']:.4f} s/step (median of "
          f"steps 2-{CLI_STEPS}), {wall:.1f} s for the whole call; NCCL "
          f"{rec['nccl']}; launches per step {launches[0]} (expected phase "
          f"18's {step_launches}); losses {[round(st['loss'], 5) for st in steps]}"
          f" against phase 24's {[round(st['loss'], 5) for st in cli_steps]} "
          f"(relative {['%.2e' % r for r in rel]}; the first step's gradient "
          f"norm {norm_rel:.2e}); checkpoint keys with "
          f"module. {rec['module_keys']}; test CLI rc {rc_test}, "
          f"{len(results)} results", flush=True)
    if not rec["nccl"]:
        raise AssertionError("the train CLI did not run on NCCL")
    if CHECK_LAUNCHES and any(la != step_launches for la in launches):
        raise AssertionError(f"launches per step {launches} != "
                             f"{step_launches}")
    # the first step's forward is phase 24's (to the bit in every run so far)
    # and its backward within the atomics' order.  The later steps drift
    # with that order through AdamW, and no bound of that drift has been
    # measured (two readings each, on an NVIDIA H100 80GB HBM3 at 700 W: two
    # runs of phase 24, up to 8.6e-4 at step 4; this phase against phase 24,
    # 2.9e-3 and 3.8e-3), so they are printed and not held; 31b holds data
    # parallel's arithmetic against one process
    if (len(steps) != CLI_STEPS or not rel[0] <= 1e-6
            or not norm_rel <= TINY_REL_TOL
            or not all(np.isfinite(st["loss"]) for st in steps)):
        raise AssertionError(f"losses differ from phase 24's: {rel}, the "
                             f"first gradient norm by {norm_rel}")
    if rec["module_keys"] or rc_test != 0 or len(results) != 2 * nproc:
        raise AssertionError(f"bad checkpoint or test CLI: {rec}\n{err_test}")
    return rec


def phase_ddp_ranks(n=2, backend="gloo"):
    where = ("spawned on the one card" if backend == "gloo"
             else "spawned one to a card")
    print(f"phase 31b: {n} {backend} ranks {where} (the tiny LC model at B=1 "
          f"each, DistributedDataParallel) against one process at B={n}: two "
          f"train steps, the eval gather of 3 samples, the flags of two "
          f"train-mode steps (tools/ddp_check.py)", flush=True)
    from unibev_tpu_torch.tools import ddp_check
    work = os.path.join(ROOT, "build", "ddp_check")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = ddp_check.run_ranks(n, "cuda", work, backend)
    ref = ddp_check.one_process(n, "cuda")
    worst = ddp_check.compare(ranks, ref)
    worst["wall_s"] = time.perf_counter() - t0
    print(f"  worst relative errors against one process: losses "
          f"{worst['losses']:.3e}, first-step gradients {worst['grads']:.3e}, "
          f"LiDAR running statistics {worst['stats']:.3e} (tol "
          f"{ddp_check.REL}); {worst['state_tensors']} parameters and buffers "
          f"bit-identical across the ranks; flags {worst['flags']} on all; "
          f"gathered mAP {worst['metric']['mAP']:.4f} = one process's; "
          f"{worst['wall_s']:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return worst



def compare_bitmap_kernels():
    """``--compare``'s K10 and K11 part: the device time (profiler) and the
    host's time a call (``host_us``) of K10 at the LiDAR site (the flagship
    cloud) and the radar site (the RC batch's pillars), and of K11 at each
    of the 5 table calls of a forward and over the 5, through the public
    wrappers alone (an earlier checkout has no plans)."""
    print("K10 and K11: device ms a call (profiler), host us a call",
          flush=True)
    points = synthetic_batch(np.random.RandomState(0), device="cuda")["points"][0]
    mask = torch.ones(points.shape[0], dtype=torch.bool, device="cuda")
    batch = _rc_batch()
    radar, radar_mask = batch["radar"][0], batch["radar_mask"][0]
    del batch
    radar_args = (RADAR_LAYER["voxel_size"], RADAR_LAYER["point_cloud_range"],
                  RADAR_GRID, RADAR_LAYER["max_voxels"][1],
                  RADAR_LAYER["max_num_points"])
    runs = dict(
        k10_lidar=lambda: voxelize_and_encode(
            points, mask, VOXEL_SIZE, PC_RANGE, VOXEL_GRID, CAPACITIES[0], 10),
        k10_radar=lambda: voxelize_and_encode(radar, radar_mask, *radar_args))
    grid = res0_grid(points)[1]
    runs["k11_table0"] = lambda g=grid: build_table(g)
    for i, (kernel, stride, padding, capacity) in enumerate(STRIDED_CONVS):
        out_shape = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                          zip(grid.shape, padding, kernel, stride))
        args = (grid, kernel, stride, padding, out_shape, capacity)
        name = "conv_out" if i == len(DOWN_PADDINGS) else f"down{i}"
        runs[f"k11_{name}"] = lambda a=args: downsample_with_table(*a)
        co, mo, _, _ = downsample_with_table(*args)
        grid = SparseGrid(co, mo, out_shape, grid.batch)
    out = {}
    for name, run in runs.items():
        out[name] = dict(device_ms=device_ms(run, 20), host_us=host_us(run))
        print(f"  {name}: device {out[name]['device_ms']:.4f} ms, host "
              f"{out[name]['host_us']:.1f} us", flush=True)
    k11 = [v for k, v in out.items() if k.startswith("k11_")]
    out["k11_sum"] = {k: sum(v[k] for v in k11)
                      for k in ("device_ms", "host_us")}
    print(f"  k11 over the 5 calls: device {out['k11_sum']['device_ms']:.4f} "
          f"ms, host {out['k11_sum']['host_us']:.1f} us", flush=True)
    return out


def compare_lsa_kernel(model, batch, gen):
    """``--compare``'s K12 part: the device time (profiler) and events time
    and the host's time a call (``host_us``) of K12 on the problems of one
    ``head.loss`` of ``model`` (phase 19c's case a), through the public
    wrapper alone."""
    from unibev_tpu_torch.core.bbox.lsa import linear_sum_assignment
    from unibev_tpu_torch.parallel.train_state import compute_autocast
    with torch.no_grad(), compute_autocast(model):
        preds = model(batch, gen)
    cost, valid = lsa_cases(model.pts_bbox_head, preds, batch)["a loss"]
    del preds

    def run():
        return linear_sum_assignment(cost, valid)
    out = dict(device_ms=device_ms(run, 50), ms=cuda_ms(run, 50),
               host_us=host_us(run))
    print(f"K12 on the loss's {tuple(cost.shape)} problems: device "
          f"{out['device_ms']:.4f} ms, events {out['ms']:.4f} ms, host "
          f"{out['host_us']:.1f} us a call", flush=True)
    return out


def compare_only():
    """``--compare``: K10's and K11's device and host time at their sites
    (``compare_bitmap_kernels``), then the flagship paths' walls and device
    profiles alone (phases 5-6, 9-10, 13-15, 18-19), with the launch counts
    printed but not held to this file's tables, and K12 on the LC train
    model's loss problems (``compare_lsa_kernel``).  To compare two checkouts
    with one harness, copy this file into the other's root and run both in
    one call, in the order A B B A."""
    global CHECK_LAUNCHES
    CHECK_LAUNCHES = False
    print(f"package {os.path.join(ROOT, 'unibev_tpu_torch')}", flush=True)
    compare_bitmap_kernels()
    torch.cuda.empty_cache()
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
        if lidar:
            compare_lsa_kernel(model, batch, tgen)
        del model, opt, sched, batch, tgen
    return 0


def radar_and_data_parallel(gen, lc_step_launches, cli_steps):
    """Phases 27-31: the radar branch at its K5 site, in the tiny RC model
    and at full width, and data parallel through the CLIs (NCCL) and two
    gloo ranks on the card."""
    k5 = phase_radar_scatter(gen)
    tiny_rc = phase_tiny_rc()
    torch.cuda.empty_cache()
    rc = phase_flagship_rc()
    torch.cuda.empty_cache()
    rc_train = phase_flagship_rc_train()
    torch.cuda.empty_cache()
    ddp_cli = phase_ddp_cli(lc_step_launches, cli_steps)
    ddp_gloo = phase_ddp_ranks()
    return dict(k5=k5, tiny_rc=tiny_rc, rc=rc, rc_train=rc_train,
                ddp_cli=ddp_cli, ddp_gloo=ddp_gloo)


def radar_dp_only(gen):
    """``--radar-dp``: phases 27-31 alone, with phase 24 for 31a's
    reference losses and phase 18's launches derived from the call sites."""
    expected = expected_train_launches(lidar=True)
    train_cli, _ = phase_train_cli(expected, float("nan"))
    rec = radar_and_data_parallel(gen, expected, train_cli["steps"])
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_radar_dp.json"),
              "w") as f:
        json.dump(rec, f, indent=1, default=str)
    raise_trace_faults()
    return 0


def ddp_cards_only(n):
    """``--ddp-cards N``: phase 31 on N cards of one host: the train and
    test CLIs with one NCCL rank a card (their launches per step held to the
    call sites' counts, phase 18's), and tools/ddp_check.py's N NCCL ranks
    against one process at N times the batch on the first card."""
    if torch.cuda.device_count() < n:
        raise AssertionError(f"--ddp-cards {n}: {torch.cuda.device_count()} "
                             f"cards")
    cli = phase_ddp_cli(expected_train_launches(lidar=True), [], nproc=n)
    ranks = phase_ddp_ranks(n, "nccl")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"chip_smoke_ddp{n}.json"),
              "w") as f:
        json.dump(dict(ddp_cli=cli, ddp_ranks=ranks), f, indent=1, default=str)
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
    if len(argv) == 2 and argv[0] == "--ddp-cards":
        _build.lib()
        return ddp_cards_only(int(argv[1]))
    if argv == ["--radar-dp"]:
        _build.lib()
        return radar_dp_only(torch.Generator(device="cuda").manual_seed(0))
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
    k13 = phase_frozen_bn(gen)
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
    k6, k7, k10, k11, lidar_counts = phase_sparse(gen)
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
    sync = phase_sync_check(model, opt, sched, batch, tgen)
    k12 = phase_lsa(model, batch, tgen)
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
    radar = radar_and_data_parallel(gen, lc_steps, train_cli["steps"])
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
                     radar["rc"]["RC"]["launches"]["scatter_add_rows"],
                     radar["k5"], library_ms=radar["k5"]["library_ms"]),
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
        kernel_entry("voxelize", "unibev_tpu_torch/csrc/voxelize.cu",
                     "unibev_tpu/ops/voxelize.py:41",
                     lc["launches"]["voxelize"], k10),
        kernel_entry("active_set", "unibev_tpu_torch/csrc/active_set.cu",
                     "unibev_tpu/ops/sparse_conv.py:154",
                     lc["launches"]["active_set"], k11),
        kernel_entry("lsa", "unibev_tpu_torch/csrc/lsa.cu",
                     "unibev_tpu/core/bbox/lsa.py:31", lc_steps["lsa"], k12,
                     library_ms=k12["library_ms"]),
        dict(kernel_entry("frozen_bn_act",
                          "unibev_tpu_torch/csrc/frozen_bn_act.cu",
                          "none (XLA's fusion of unibev_tpu/models/backbones/"
                          "resnet.py:49)", lc["launches"]["frozen_bn_act"],
                          k13), device_ms=k13["device_ms"]),
    ]
    # K10 also carries the RC model's radar site (phase 27), one launch a
    # forward there
    radar_vox = radar["k5"]["voxelizer"]
    vox = next(k for k in kernels if k["name"] == "voxelize")
    vox["max_abs_err"] = max(vox["max_abs_err"], radar_vox["max_abs_err"])
    vox.update(radar_launches=radar["rc"]["RC"]["launches"]["voxelize"],
               radar_ms=radar_vox["ms"], radar_plain_ms=radar_vox["plain_ms"],
               radar_bound_ms=radar_vox["bound_ms"])
    # K1 and K3 also carry cat_128's D = 16 sites (phase 20), summed over
    # their launches in one cat_128 LC forward / step
    for entry, rec in ((kernels[0], msda_d16), (kernels[3], msda_bwd_d16)):
        entry["max_abs_err"] = max(entry["max_abs_err"], rec["max_abs_err"])
        entry.update(d16_ms=rec["ms"], d16_plain_ms=rec["plain_ms"],
                     d16_bound_ms=rec["bound_ms"])
    raise_trace_faults()
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count())
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
                       build_s=build_s, ptxas=ptxas, msda=msda, dcn_fwd=dcn,
                       dcn_im2col=dcn_cols, frozen_bn_act=k13,
                       tiny=tiny,
                       flagship=flagship, profile=prof, backward=bwd,
                       tiny_train=tiny_train, train=train,
                       profile_train=prof_train, sparse_nbr=k6,
                       sparse_conv=k7, voxelize=k10, active_set=k11,
                       lidar_counts=lidar_counts,
                       tiny_lc=tiny_lc, lc=lc, l_only=l_only,
                       profile_lc=prof_lc, profile_l=prof_l,
                       sparse_inv_nbr=k8, sparse_conv_wgrad=k9,
                       sparse_conv_bwd=k7_bwd, tiny_lc_train=tiny_lc_train,
                       lc_train=lc_train, profile_lc_train=prof_lc_train,
                       sync_check=sync, lsa=k12,
                       msda_d16=msda_d16, msda_bwd_d16=msda_bwd_d16,
                       tiny_variants=tiny_variants, configs=configs,
                       cat_train=cat_train, train_cli=train_cli,
                       test_cli=test_cli, disk_cli=disk_cli, radar=radar,
                       kernels=kernels, device=device), f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
