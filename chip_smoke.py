#!/usr/bin/env python3
"""Smoke run of the PyTorch port (unibev_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from unibev_tpu_torch/csrc with nvcc,
then, each phase printing one line (or a few) and raising on any failure:

  1. the card (nvidia-smi name and power limit), torch / CUDA versions and
     the kernel build time;
  2. kernel K1 (MSDA) against its plain PyTorch version at the three
     flagship call shapes, in f32 (TF32 off) and bf16, with both times;
  3. kernel K2 (DCNv2 im2col) the same way at the stage-3 and stage-4 shapes;
  4. the tiny camera-only model: CUDA with the kernels against the CPU with
     the plain versions, same weights and inputs;
  5. full-width flagship camera-only predict in bf16 (6 cameras at
     928x1600): launch counts of one forward, ms per sample (median of 10
     synchronized iterations after 3 warm-ups), peak memory, SCA overflow,
     finite boxes;
  6. a torch.profiler breakdown of one forward by kernel;
  7. the backward kernels against their plain versions (autograd through
     the plain forwards) at the flagship call sites, f32 (TF32 off) and
     bf16, with both times: K3 msda_bwd and K4 dcn_bwd (each timed with the
     K5 scatter-adds it ends in), and K5 scatter_add_rows alone on one chunk
     of contribution rows per site;
  8. one tiny camera-only train step on CUDA against the same step on the
     CPU: losses, gradients and the parameters after the step;
  9. the full-width flagship camera-only train step (float32 parameters,
     bf16 autocast, GridMask and dropout on, AdamW): launch counts of one
     step against the counts derived from the call sites, s/step (median of
     10 after 3 warm-ups), peak memory, finite losses and grad norm, SCA
     overflow, frozen parameters bit-identical after the steps;
 10. a torch.profiler breakdown of one train step by kernel;
 11. the voxelizer's time on the synthetic batch's 300k points, and the
     sparse-conv kernels against their plain versions at every flagship
     LiDAR site, on the active sets and rulebooks of the voxelized synthetic
     batch: K6 sparse_nbr exactly, K7 sparse_conv in f32 (TF32 off) and
     bf16, with both times;
 12. the tiny LC model in LC and L mode: CUDA with the kernels against the
     CPU with the plain versions, same weights and inputs;
 13. full-width flagship LC predict in bf16 (6 cameras at 928x1600 and 300k
     points): launch counts of one forward (18 K1, 26 K2, 8 K6, 21 K7), ms
     per sample (median of 10 after 3 warm-ups), peak memory, SCA overflow,
     finite boxes, and, printed, the voxels before the cap and each strided
     conv's overflow;
 14. L predict on the same model (the batch without images): launch counts
     (12 K1, 0 K2, 8 K6, 21 K7) and ms per sample;
 15. torch.profiler breakdowns of one LC and one L forward by kernel.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Numbers are also written to
chiprun_out/chip_smoke.json.  Exits non-zero without a CUDA device or when
any phase fails.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from unibev_tpu_torch.flagship import (PC_RANGE,  # noqa: E402
                                       VOXEL_SIZE, build_flagship,
                                       build_model, synthetic_batch,
                                       tiny_batch, tiny_model_cfg)
from unibev_tpu_torch.ops import _build  # noqa: E402
from unibev_tpu_torch.ops.deform_conv import (  # noqa: E402
    deform_im2col, deform_im2col_backward, deform_im2col_reference,
    modulated_deform_conv2d, modulated_deform_conv2d_reference, tap_interior)
from unibev_tpu_torch.ops.msda import (cell_interior,  # noqa: E402
                                       ms_deform_attn, ms_deform_attn_backward,
                                       ms_deform_attn_reference)
from unibev_tpu_torch.ops.scatter import (bwd_chunks,  # noqa: E402
                                          scatter_add_rows,
                                          scatter_add_rows_reference)
from unibev_tpu_torch.ops.sparse_conv import (  # noqa: E402
    SparseGrid, build_table, downsample_with_table, sparse_conv,
    sparse_conv_reference, sparse_nbr, sparse_nbr_reference)
from unibev_tpu_torch.ops.voxelize import voxelize_and_encode  # noqa: E402
from unibev_tpu_torch.parallel.train_state import (make_optimizer,  # noqa: E402
                                                   train_step)

# Relative tolerances, on max |ref| (at least 1).  f32: kernel and plain
# version sum the same terms in another order.  bf16: outputs are rounded to
# bf16 (relative 2^-8), and the DCN product sums 9 * Cin rounded columns.
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}
TINY_REL_TOL = 1e-3     # CPU vs CUDA through a depth-50 backbone, f32, TF32 off
# Backwards: the same relative tolerances.  f32: float32 atomics sum the
# contribution rows in no fixed order.  bf16: each contribution row is
# rounded to bf16 before the float32 sum.  K5 alone: 1e-5 (atomic order).
# d_loc and d_offset jump across cell edges, where the kernels and
# grid_sample may round a position to different sides; they are compared at
# points 1e-3 pixels or more inside a cell (cell_interior / tap_interior).
BWD_REL_TOL = REL_TOL
SCATTER_REL_TOL = 1e-5

# (name, calls per flagship forward, B, V, Q, heads, D, levels, points):
# the camera-only path's sites (forward and train step), then the LiDAR
# cross-attention's, which LC adds (forward only)
MSDA_SITES = [
    ("tsa", 3, 1, 40000, 40000, 8, 32, ((200, 200),), 4),
    ("camera_sca", 3, 6, 1450, 10240, 8, 32, ((29, 50),), 8),
    ("decoder_ca", 6, 1, 40000, 900, 8, 32, ((200, 200),), 4),
]
LIDAR_MSDA_SITES = [
    ("pts_sca", 3, 1, 32400, 40000, 8, 32, ((180, 180),), 8),
]
# (name, calls per flagship forward, B, H, W, Cin, Cout)
DCN_SITES = [
    ("stage3", 23, 6, 58, 100, 256, 256),
    ("stage4", 3, 6, 29, 50, 512, 512),
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
    print("phase 2: K1 msda_fwd vs ms_deform_attn_reference", flush=True)
    rec = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, sites={})
    for name, calls, B, V, Q, heads, D, levels, P in MSDA_SITES + LIDAR_MSDA_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, attn = _msda_inputs(gen, B, V, Q, heads, D, levels, P,
                                            dtype)
            got = ms_deform_attn(value, levels, loc, attn)
            want = ms_deform_attn_reference(value, levels, loc, attn)
            err = check(f"{name} {str(dtype)[6:]}", got, want, REL_TOL[dtype])
            if dtype is torch.bfloat16:
                ms = cuda_ms(lambda: ms_deform_attn(value, levels, loc, attn), 20)
                plain = cuda_ms(lambda: ms_deform_attn_reference(value, levels, loc, attn), 5)
                print(f"  {name} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms "
                      f"(x{calls} per forward)", flush=True)
                rec["sites"][name] = dict(ms=ms, plain_ms=plain, calls=calls, err=err)
                rec["ms"] += calls * ms
                rec["plain_ms"] += calls * plain
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return rec


def phase_dcn(gen):
    print("phase 3: K2 dcn_im2col vs deform_im2col_reference", flush=True)
    rec = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, sites={})
    for name, calls, B, H, W, Cin, Cout in DCN_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            x, off, mask = _dcn_inputs(gen, B, H, W, Cin, dtype)
            w = (torch.randn(9 * Cin, Cout, device="cuda", generator=gen)
                 * (9 * Cin) ** -0.5).to(dtype)
            tag = f"{name} {str(dtype)[6:]}"
            err = check(tag + " cols", deform_im2col(x, off, mask),
                        deform_im2col_reference(x, off, mask), REL_TOL[dtype])
            check(tag + " conv", modulated_deform_conv2d(x, off, mask, w),
                  modulated_deform_conv2d_reference(x, off, mask, w), REL_TOL[dtype])
            if dtype is torch.bfloat16:
                ms = cuda_ms(lambda: deform_im2col(x, off, mask), 20)
                plain = cuda_ms(lambda: deform_im2col_reference(x, off, mask), 5)
                print(f"  {name} bf16 im2col: kernel {ms:.4f} ms, plain {plain:.4f} ms "
                      f"(x{calls} per forward)", flush=True)
                rec["sites"][name] = dict(ms=ms, plain_ms=plain, calls=calls, err=err)
                rec["ms"] += calls * ms
                rec["plain_ms"] += calls * plain
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return rec


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
    launches = dict(_build.launches)
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
    if launches != {"msda_fwd": 12, "dcn_im2col": 26}:
        raise AssertionError(f"expected 12 MSDA and 26 DCN launches, got {launches}")
    if overflow != 0 or not finite or tuple(boxes.shape) != (1, 300, 9):
        raise AssertionError(f"bad flagship output: {rec}")
    return model, batch, rec


def phase_backward(gen):
    print("phase 7: K3 msda_bwd, K4 dcn_bwd (with their K5 scatter-adds) and "
          "K5 scatter_add_rows vs plain versions", flush=True)
    recs = {k: dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, sites={})
            for k in ("msda_bwd", "dcn_bwd", "scatter_add_rows")}

    def record(kernel, site, calls, ms, plain, err):
        rec = recs[kernel]
        rec["sites"][site] = dict(ms=ms, plain_ms=plain, calls=calls, err=err)
        rec["ms"] += calls * ms
        rec["plain_ms"] += calls * plain
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        print(f"  {kernel} {site} bf16: kernel {ms:.4f} ms, plain {plain:.4f} "
              f"ms (x{calls} per train step)", flush=True)

    def scatter_site(site, calls, M, L, tr):
        idx = torch.randint(0, tr, (M,), device="cuda", generator=gen,
                            dtype=torch.int32)
        contrib = torch.randn(M, L, device="cuda", generator=gen).bfloat16()
        err = check(f"{site} scatter", scatter_add_rows(idx, contrib, tr),
                    scatter_add_rows_reference(idx, contrib, tr),
                    SCATTER_REL_TOL)
        record("scatter_add_rows", site, calls,
               cuda_ms(lambda: scatter_add_rows(idx, contrib, tr), 20),
               cuda_ms(lambda: scatter_add_rows_reference(idx, contrib, tr), 5),
               err)

    for name, calls, B, V, Q, heads, D, levels, P in MSDA_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, attn = _msda_inputs(gen, B, V, Q, heads, D, levels, P,
                                            dtype)
            g = torch.randn(B, Q, heads * D, device="cuda", generator=gen).to(dtype)
            got = ms_deform_attn_backward(value, levels, loc, attn, g)
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
                record("msda_bwd", name, calls,
                       cuda_ms(lambda: ms_deform_attn_backward(value, levels, loc,
                                                               attn, g), 10),
                       cuda_ms(plain, 3), max(errs))
            del plain, got
        chunk = bwd_chunks(B * Q, heads * len(levels) * P * 4 * D * 2)
        scatter_site(name, calls * len(chunk), chunk[0][1] * heads * len(levels)
                     * P * 4, D, B * V * heads)

    for name, calls, B, H, W, Cin, _ in DCN_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            x, off, mask = _dcn_inputs(gen, B, H, W, Cin, dtype)
            d_cols = torch.randn(B * H * W, 9 * Cin, device="cuda",
                                 generator=gen).to(dtype)
            got = deform_im2col_backward(x, off, mask, d_cols)
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
                record("dcn_bwd", name, calls,
                       cuda_ms(lambda: deform_im2col_backward(x, off, mask,
                                                              d_cols), 10),
                       cuda_ms(plain, 3), max(errs))
            del plain, got
        chunk = bwd_chunks(B * H * W, 9 * 4 * Cin * 2)
        scatter_site(name, calls * len(chunk), chunk[0][1] * 36, Cin, B * H * W)
    torch.cuda.empty_cache()
    return recs


def expected_train_launches():
    """Kernel launches of one flagship C train step, from the call sites:
    K1 once per MSDA call; K2 once per DCN call and once more in the
    backbone's checkpoint recompute; K3 and K4 once per chunk of their
    call's contribution rows (bf16, ops/scatter.py::bwd_chunks); K5 once
    after each K3 or K4 launch."""
    msda_bwd = sum(calls * len(bwd_chunks(B * Q, heads * len(lv) * P * 4 * D * 2))
                   for _, calls, B, _, Q, heads, D, lv, P in MSDA_SITES)
    dcn_bwd = sum(calls * len(bwd_chunks(B * H * W, 9 * 4 * Cin * 2))
                  for _, calls, B, H, W, Cin, _ in DCN_SITES)
    return dict(msda_fwd=sum(s[1] for s in MSDA_SITES), msda_bwd=msda_bwd,
                dcn_im2col=2 * sum(s[1] for s in DCN_SITES), dcn_bwd=dcn_bwd,
                scatter_add_rows=msda_bwd + dcn_bwd)


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


def phase_tiny_train():
    print("phase 8: tiny C-only train step, CUDA kernels vs CPU plain versions",
          flush=True)
    cpu_model = build_model(tiny_model_cfg(), "cpu", seed=0, train=True).eval()
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    start = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    batch = tiny_batch(np.random.RandomState(0))
    gpu_batch = {k: v.to("cuda") for k, v in batch.items()}
    metrics = []
    for model, b in ((cpu_model, batch), (gpu_model, gpu_batch)):
        opt, sched = make_optimizer(model)
        before = dict(_build.launches)
        metrics.append(train_step(model, opt, sched, b))
        torch.cuda.synchronize()
    launched = {k for k, v in _build.launches.items() if v > before.get(k, 0)}
    if not {"msda_bwd", "dcn_bwd", "scatter_add_rows"} <= launched:
        raise AssertionError(f"the tiny CUDA step launched only {launched}")
    cpu_p = dict(cpu_model.named_parameters())
    gpu_p = {n: p.detach().cpu() for n, p in gpu_model.named_parameters()}
    grads = {n: p.grad for n, p in cpu_p.items() if p.grad is not None}
    rec = dict(
        losses=check_each("losses", metrics[1], metrics[0], TINY_REL_TOL),
        grads=check_each("gradients", {n: gpu_model.get_parameter(n).grad
                                       for n in grads}, grads, TINY_REL_TOL))
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


def phase_flagship_train(iters=10):
    print("phase 9: full-width flagship camera-only train step (f32 params, "
          "bf16 autocast)", flush=True)
    model = build_flagship(use_lidar=False, device="cuda", dtype=torch.bfloat16,
                           seed=0, train=True)
    batch = synthetic_batch(np.random.RandomState(0), device="cuda")
    opt, sched = make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    for _ in range(3):                                     # warm-up
        train_step(model, opt, sched, batch, gen)
    torch.cuda.synchronize()

    for k in list(_build.launches):
        _build.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    metrics = train_step(model, opt, sched, batch, gen)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        train_step(model, opt, sched, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    s_step = float(np.median(times))
    values = {k: float(v) for k, v in metrics.items()}
    overflow = int(values.pop("sca_overflow"))
    finite = all(np.isfinite(v) for v in values.values())
    still = all(torch.equal(p, frozen[n]) for n, p in model.named_parameters()
                if n in frozen)
    expected = expected_train_launches()
    rec = dict(s_per_step=s_step, s_min=min(times), s_max=max(times),
               iters=iters, peak_bytes=peak, launches=launches,
               expected_launches=expected, metrics=values,
               sca_overflow=overflow, finite=finite,
               frozen_params=len(frozen), frozen_unchanged=still)
    print(f"  {s_step:.4f} s/step (median of {iters}; min {min(times):.4f}, "
          f"max {max(times):.4f}); peak {peak / 2 ** 30:.2f} GiB; loss "
          f"{values['loss']:.4f} grad_norm {values['grad_norm']:.4f}; "
          f"sca_overflow {overflow}; {len(frozen)} frozen parameters "
          f"unchanged {still}", flush=True)
    print(f"  launches per step {launches} (expected {expected})", flush=True)
    if launches != expected:
        raise AssertionError(f"launches per step {launches} != {expected}")
    if overflow != 0 or not finite or not still or not frozen:
        raise AssertionError(f"bad flagship train step: {rec}")
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
    SparseEncoder builds them: (K6 sites, K7 sites, counts).

    A K6 site is (name, sparse_nbr arguments); a K7 site is (name, calls per
    forward, Cin, Cout, rows of its input, rulebook, output mask).  The
    counts are the voxels before the cap and each strided conv's overflow.
    """
    mask = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    vox = voxelize_and_encode(points, mask, *voxel, capacities[0])
    zero = torch.zeros_like(vox.coords[:, :1])
    coords = torch.where(vox.mask[:, None], torch.cat([zero, vox.coords], 1), -1)
    grid = SparseGrid(coords.contiguous(), vox.mask, sparse_shape, 1)
    table = build_table(grid)
    k6, k7, overflow = [], [], []

    def subm(i, grid, table):
        args = (table, grid.coords.shape[0], grid.shape, grid.coords,
                grid.mask, (3, 3, 3), (1, 1, 1), (1, 1, 1))
        k6.append((f"subm{i}", args))
        return sparse_nbr_reference(*args)

    def strided(name, grid, table, kernel, stride, padding, capacity):
        out_shape = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                          zip(grid.shape, padding, kernel, stride))
        co, mo, table_out, over = downsample_with_table(
            grid, table, kernel, stride, padding, out_shape, capacity)
        args = (table, grid.coords.shape[0], grid.shape, co, mo, kernel,
                stride, padding)
        k6.append((name, args))
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
    counts = dict(num_distinct_voxels=int(vox.num_distinct),
                  num_voxels=int(vox.num_voxels), sparse_overflow=overflow)
    return k6, k7, counts


def phase_sparse(gen):
    print("phase 11: K6 sparse_nbr and K7 sparse_conv vs their plain versions "
          "at the flagship LiDAR sites", flush=True)
    points = synthetic_batch(np.random.RandomState(0), device="cuda")["points"][0]
    k6, k7, counts = lidar_sites(points)
    mask = torch.ones(points.shape[0], dtype=torch.bool, device="cuda")
    counts["voxelizer_ms"] = cuda_ms(lambda: voxelize_and_encode(
        points, mask, VOXEL_SIZE, PC_RANGE, VOXEL_GRID, CAPACITIES[0]), 10)
    print(f"  voxelized synthetic batch: {counts}", flush=True)
    rec6 = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, sites={})
    for name, args in k6:
        got, want = sparse_nbr(*args), sparse_nbr_reference(*args)
        if not torch.equal(got, want):
            raise AssertionError(f"K6 {name}: {int((got != want).sum())} "
                                 f"entries differ from the plain version")
        ms = cuda_ms(lambda: sparse_nbr(*args), 20)
        plain = cuda_ms(lambda: sparse_nbr_reference(*args), 5)
        live = int((want < args[1]).sum())
        print(f"  K6 {name}: {tuple(want.shape)} equal ({live} live entries); "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms", flush=True)
        rec6["sites"][name] = dict(ms=ms, plain_ms=plain, calls=1,
                                   shape=list(want.shape), live=live)
        rec6["ms"] += ms
        rec6["plain_ms"] += plain
    rec7 = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, sites={})
    for name, calls, cin, cout, rows, nidx, mask in k7:
        K = nidx.shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            feats = torch.randn(rows, cin, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(K * cin, cout, device="cuda", generator=gen)
                 * (K * cin) ** -0.5).to(dtype)
            err = check(f"K7 {name} {str(dtype)[6:]}", sparse_conv(feats, nidx, w, mask),
                        sparse_conv_reference(feats, nidx, w, mask), REL_TOL[dtype])
            if dtype is torch.bfloat16:
                ms = cuda_ms(lambda: sparse_conv(feats, nidx, w, mask), 10)
                plain = cuda_ms(lambda: sparse_conv_reference(feats, nidx, w, mask), 5)
                print(f"  K7 {name} bf16 ({nidx.shape[0]} x {K} taps, {cin} -> "
                      f"{cout}): kernel {ms:.4f} ms, plain {plain:.4f} ms "
                      f"(x{calls} per forward)", flush=True)
                rec7["sites"][name] = dict(ms=ms, plain_ms=plain, calls=calls,
                                           err=err)
                rec7["ms"] += calls * ms
                rec7["plain_ms"] += calls * plain
                rec7["max_abs_err"] = max(rec7["max_abs_err"], err)
    del k6, k7
    torch.cuda.empty_cache()
    return rec6, rec7, counts


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


def _predict_run(model, batch, iters, expected, label):
    """Launch counts of one predict (asserted against ``expected``), peak
    memory, and ms per sample (median of ``iters`` after 3 warm-ups)."""
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
        times.append((time.perf_counter() - t0) * 1000
                     / batch["points"].shape[0])
    ms = float(np.median(times))
    boxes, scores = out["bboxes"], out["scores"]
    finite = bool(torch.isfinite(boxes).all() and torch.isfinite(scores).all())
    rec = dict(ms_per_sample=ms, ms_min=min(times), ms_max=max(times),
               iters=iters, peak_bytes=peak, launches=launches,
               sca_overflow=int(out["sca_overflow"]), boxes_finite=finite,
               boxes_shape=list(boxes.shape), n_valid=int(out["valid"].sum()),
               num_distinct_voxels=out["num_distinct_voxels"].tolist(),
               sparse_overflow=out["sparse_overflow"].tolist())
    print(f"  {label}: {ms:.2f} ms/sample (median of {iters}; min "
          f"{min(times):.2f}, max {max(times):.2f}); peak "
          f"{peak / 2 ** 30:.2f} GiB; launches per forward {launches}; "
          f"sca_overflow {rec['sca_overflow']}; boxes finite {finite} "
          f"{tuple(boxes.shape)}; voxels before the cap "
          f"{rec['num_distinct_voxels']}, strided-conv overflow "
          f"{rec['sparse_overflow']}", flush=True)
    if launches != expected:
        raise AssertionError(f"{label}: expected launches {expected}, got {launches}")
    if rec["sca_overflow"] != 0 or not finite or tuple(boxes.shape) != (1, 300, 9):
        raise AssertionError(f"bad flagship {label} output: {rec}")
    return rec


def phase_flagship_lc(iters=10):
    print("phase 13: full-width flagship LC predict, bf16", flush=True)
    model = build_flagship(device="cuda", dtype=torch.bfloat16, seed=0)
    batch = synthetic_batch(np.random.RandomState(0), device="cuda")
    rec = _predict_run(model, batch, iters, dict(
        msda_fwd=18, dcn_im2col=26, sparse_nbr=8, sparse_conv=21), "LC")
    return model, batch, rec


def phase_flagship_l(model, batch, iters=10):
    print("phase 14: L predict on the same model (no images), bf16", flush=True)
    batch = {k: v for k, v in batch.items() if k != "img"}
    return batch, _predict_run(model, batch, iters, dict(
        msda_fwd=12, sparse_nbr=8, sparse_conv=21), "L")



def _category(kernel_name):
    n = kernel_name.lower()
    if "msda_fwd" in n:
        return "K1 msda_fwd"
    if "dcn_im2col" in n:
        return "K2 dcn_im2col"
    if "msda_bwd" in n:
        return "K3 msda_bwd"
    if "dcn_bwd" in n:
        return "K4 dcn_bwd"
    if "scatter_add_rows" in n:
        return "K5 scatter_add_rows"
    if "sparse_nbr" in n:
        return "K6 sparse_nbr"
    if "sparse_conv" in n:
        return "K7 sparse_conv"
    if "sort" in n:
        return "sort (voxelizer, SCA top-K order)"
    if "index" in n or "scatter" in n or "scan" in n or "cum" in n:
        return "index_add, index_copy, scatter, scans"
    if "pool" in n:
        return "max pooling (ResNet stem, strided active sets)"
    if "fprop" in n or "dgrad" in n or "wgrad" in n or "conv" in n \
            or "addpadding" in n:
        return "convolution (cuDNN)"
    if "gemm" in n or "nvjet" in n or "cutlass" in n:
        return "matmul (cuBLAS)"
    return "elementwise, norms and other"


def _profile(run, wall_ms):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
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
    top = [dict(name=e.key[:120], calls=e.count,
                device_ms=e.self_device_time_total / 1000) for e in events[:30]]
    return dict(device_ms_total=total_ms, idle_share=idle, by_category=by_cat,
                top=top)


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


def phase_profile_train(model, opt, sched, batch, gen, wall_ms):
    print("phase 10: torch.profiler breakdown of one train step (device "
          "kernels)", flush=True)
    return _profile(lambda: train_step(model, opt, sched, batch, gen), wall_ms)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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

    gen = torch.Generator(device="cuda").manual_seed(0)
    msda = phase_msda(gen)
    dcn = phase_dcn(gen)
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
    steps = train["launches"]
    del model, opt, sched, batch, tgen
    torch.cuda.empty_cache()
    k6, k7, lidar_counts = phase_sparse(gen)
    tiny_lc = phase_tiny_lc()
    model, batch, lc = phase_flagship_lc()
    l_batch, l_only = phase_flagship_l(model, batch)
    prof_lc, prof_l = phase_profile_lidar(model, batch, l_batch,
                                          lc["ms_per_sample"],
                                          l_only["ms_per_sample"])

    kernels = [
        dict(name="msda_fwd", route="cuda", source="unibev_tpu_torch/csrc/msda.cu",
             replaces="unibev_tpu/ops/msda_pallas.py:213",
             launches=lc["launches"]["msda_fwd"],
             max_abs_err=msda["max_abs_err"], ms=msda["ms"],
             plain_ms=msda["plain_ms"]),
        dict(name="dcn_im2col", route="cuda",
             source="unibev_tpu_torch/csrc/deform_conv.cu",
             replaces="unibev_tpu/ops/deform_conv.py:442",
             launches=lc["launches"]["dcn_im2col"],
             max_abs_err=dcn["max_abs_err"], ms=dcn["ms"],
             plain_ms=dcn["plain_ms"]),
        dict(name="msda_bwd", route="cuda", source="unibev_tpu_torch/csrc/msda.cu",
             replaces="unibev_tpu/ops/msda_pallas.py:106",
             launches=steps["msda_bwd"], max_abs_err=bwd["msda_bwd"]["max_abs_err"],
             ms=bwd["msda_bwd"]["ms"], plain_ms=bwd["msda_bwd"]["plain_ms"]),
        dict(name="dcn_bwd", route="cuda",
             source="unibev_tpu_torch/csrc/deform_conv.cu",
             replaces="unibev_tpu/ops/deform_conv.py:323",
             launches=steps["dcn_bwd"], max_abs_err=bwd["dcn_bwd"]["max_abs_err"],
             ms=bwd["dcn_bwd"]["ms"], plain_ms=bwd["dcn_bwd"]["plain_ms"]),
        dict(name="scatter_add_rows", route="cuda",
             source="unibev_tpu_torch/csrc/scatter.cu",
             replaces="unibev_tpu/ops/scatter_pallas.py:60",
             launches=steps["scatter_add_rows"],
             max_abs_err=bwd["scatter_add_rows"]["max_abs_err"],
             ms=bwd["scatter_add_rows"]["ms"],
             plain_ms=bwd["scatter_add_rows"]["plain_ms"]),
        dict(name="sparse_nbr", route="cuda",
             source="unibev_tpu_torch/csrc/sparse_conv.cu",
             replaces="unibev_tpu/ops/sparse_conv.py:170",
             launches=lc["launches"]["sparse_nbr"], max_abs_err=k6["max_abs_err"],
             ms=k6["ms"], plain_ms=k6["plain_ms"]),
        dict(name="sparse_conv", route="cuda",
             source="unibev_tpu_torch/csrc/sparse_conv.cu",
             replaces="unibev_tpu/ops/sparse_conv.py:312",
             launches=lc["launches"]["sparse_conv"], max_abs_err=k7["max_abs_err"],
             ms=k7["ms"], plain_ms=k7["plain_ms"]),
    ]
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count())
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
                       build_s=build_s, msda=msda, dcn=dcn, tiny=tiny,
                       flagship=flagship, profile=prof, backward=bwd,
                       tiny_train=tiny_train, train=train,
                       profile_train=prof_train, sparse_nbr=k6,
                       sparse_conv=k7, lidar_counts=lidar_counts,
                       tiny_lc=tiny_lc, lc=lc, l_only=l_only,
                       profile_lc=prof_lc, profile_l=prof_l, kernels=kernels,
                       device=device), f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
