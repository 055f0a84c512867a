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
 10. a torch.profiler breakdown of one train step by kernel.

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

from unibev_tpu_torch.flagship import (build_flagship, build_model,  # noqa: E402
                                       synthetic_batch, tiny_batch,
                                       tiny_model_cfg)
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

# (name, calls per flagship forward, B, V, Q, heads, D, levels, points)
MSDA_SITES = [
    ("tsa", 3, 1, 40000, 40000, 8, 32, ((200, 200),), 4),
    ("camera_sca", 3, 6, 1450, 10240, 8, 32, ((29, 50),), 8),
    ("decoder_ca", 6, 1, 40000, 900, 8, 32, ((200, 200),), 4),
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
    for name, calls, B, V, Q, heads, D, levels, P in MSDA_SITES:
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

    kernels = [
        dict(name="msda_fwd", route="cuda", source="unibev_tpu_torch/csrc/msda.cu",
             replaces="unibev_tpu/ops/msda_pallas.py:213",
             launches=flagship["launches"]["msda_fwd"],
             max_abs_err=msda["max_abs_err"], ms=msda["ms"],
             plain_ms=msda["plain_ms"]),
        dict(name="dcn_im2col", route="cuda",
             source="unibev_tpu_torch/csrc/deform_conv.cu",
             replaces="unibev_tpu/ops/deform_conv.py:442",
             launches=flagship["launches"]["dcn_im2col"],
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
    ]
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count())
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
                       build_s=build_s, msda=msda, dcn=dcn, tiny=tiny,
                       flagship=flagship, profile=prof, backward=bwd,
                       tiny_train=tiny_train, train=train,
                       profile_train=prof_train, kernels=kernels,
                       device=device), f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
