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
  6. a torch.profiler breakdown of one forward by kernel.

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
    deform_im2col, deform_im2col_reference, modulated_deform_conv2d,
    modulated_deform_conv2d_reference)
from unibev_tpu_torch.ops.msda import (ms_deform_attn,  # noqa: E402
                                       ms_deform_attn_reference)

# Relative tolerances, on max |ref| (at least 1).  f32: kernel and plain
# version sum the same terms in another order.  bf16: outputs are rounded to
# bf16 (relative 2^-8), and the DCN product sums 9 * Cin rounded columns.
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}
TINY_REL_TOL = 1e-3     # CPU vs CUDA through a depth-50 backbone, f32, TF32 off

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


def phase_msda(gen):
    print("phase 2: K1 msda_fwd vs ms_deform_attn_reference", flush=True)
    rec = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, sites={})
    for name, calls, B, V, Q, heads, D, levels, P in MSDA_SITES:
        L = len(levels)
        for dtype in (torch.float32, torch.bfloat16):
            value = torch.randn(B, V, heads, D, device="cuda", generator=gen).to(dtype)
            loc = torch.rand(B, Q, heads, L, P, 2, device="cuda", generator=gen) * 1.2 - 0.1
            attn = torch.softmax(torch.randn(B, Q, heads, L * P, device="cuda",
                                             generator=gen), -1)
            attn = attn.view(B, Q, heads, L, P).to(dtype)
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
            x = torch.randn(B, H, W, Cin, device="cuda", generator=gen).to(dtype)
            off = (torch.randn(B, H, W, 18, device="cuda", generator=gen) * 2).to(dtype)
            mask = torch.rand(B, H, W, 9, device="cuda", generator=gen).to(dtype)
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


def _category(kernel_name):
    n = kernel_name.lower()
    if "msda_fwd" in n:
        return "K1 msda_fwd"
    if "dcn_im2col" in n:
        return "K2 dcn_im2col"
    if "fprop" in n or "conv" in n or "addpadding" in n:
        return "convolution (cuDNN)"
    if "gemm" in n or "nvjet" in n or "cutlass" in n:
        return "matmul (cuBLAS)"
    return "elementwise, norms and other"


def phase_profile(model, batch, wall_ms):
    print("phase 6: torch.profiler breakdown of one forward (device kernels)",
          flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.predict(batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
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
    print(f"  device busy {total_ms:.3f} ms of {wall_ms:.3f} ms/sample wall: "
          f"idle share {idle:.3f}", flush=True)
    top = [dict(name=e.key[:120], calls=e.count,
                device_ms=e.self_device_time_total / 1000) for e in events[:25]]
    return dict(device_ms_total=total_ms, idle_share=idle, by_category=by_cat,
                top=top)


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
    ]
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count())
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
                       build_s=build_s, msda=msda, dcn=dcn, tiny=tiny,
                       flagship=flagship, profile=prof, kernels=kernels,
                       device=device), f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
