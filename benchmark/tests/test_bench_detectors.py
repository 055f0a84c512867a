"""Detector files and hand-kernel files.

UniBEV's detector file gives the committed cells what the harness gave
them before detector files existed: digests recorded from that harness at
tiny sizes (the pools of the committed traffic files cut to 32 x 48
images, the initialization rules of the committed configurations, the
drawn states of the tiny models).  A tiny stateful detector defined in
test files alone (``stateful.py``, ``detectors/TinyStatefulBEV.py``) runs
through a whole CPU run on scene traffic, reads correct, and reads
incorrect under each fault of a scene's state.  The hand kernels' tables
(``kernels/<key>.json``) give the launch counts and breakdown names the
harness's one table gave."""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re

import pytest
import torch

from benchmark import check, run, spec, trace, traffic, weights
from benchmark.faults import scene_always_starts, scene_never_starts
from benchmark.reference import build as ref_build
from benchmark.tests.tiny import stateful_cell

SMALL = dict(height=32, width=48, img_hw=[32, 48], focal=30.0, azimuths=64,
             sweeps=2, points=512)
POOL_SEED = 2 ** 31 + 17
STATE_SEED = 2 ** 31 + 19
# recorded with the harness before detector files (digest / rules_digest
# below, the same sizes and seeds)
PARENT = {
    "rules lc_cnw_256":
        "b49e95ca15fc90061d67690613a31ee06bc2b6d4891797be9b2665e3c85f02e9",
    "rules c_256":
        "9da274aa340bbed91557445b6cee2c9111843b6d9225d2e2b2927afd50e43d46",
    "pool eval_lc_b1": [
        "1b7970f8b82c3e2c07f3edb23d4e964a62272563e76c9ddf5e0ada12674f7788",
        "8ed3fb02e5924f2bb105ebc5fd211290f21bf46f2680f16ab9fe2fcf0904d083",
        "12cda520981a4d2b475229c5158210508c34d2ba50e3934387c5c0e9e13586fd",
        "d8122d0525bde50be5bd05127a0714346438d32c958bb8fbf61275c84aedaa18"],
    "pool stream_c_b1": [
        "b4419cd20a25646f87271419f78e36d8da2342f864a8a85dab5a7c43838f4da9",
        "ae6f727fc4dc1739b7716a4c5a1dceec822c00e66ad3dacac6530dde4697964f",
        "1376f45c705bcdcb458e80abe4aa42bc499a508d98e5f674966e83a8dc23a2dc",
        "dcb7f6741888c2f6448298f025554f6de588bc24174db3f0470b76adbb40c2fb"],
    "state lc torch.float32":
        "8cbef01e2a0f0ae67b2f9ae6ffc99d978659262f7290ea403c8e13ebb6f815c3",
    "state lc torch.bfloat16":
        "5dee7dc478bde3ae4bb70407ecadb9d01805ae0db0f47c1b6b49e55903d6f476",
    "state c torch.float32":
        "b3ac735371b14da5431c126f0467fe736de4fa66a4cccccc6f29938331abe768",
    "state c torch.bfloat16":
        "62b5174d4d2a8508ae884eeb0963f5ab45ec1c5966e06e0fa2da195a9ff283ec",
    "state lc_fixed torch.float32":
        "9ff74536e5b8cf6e1fa331e0b39637dc5a5bd4e4e4052c081463cb60990c60fb",
    "state lc_fixed torch.bfloat16":
        "c710cf9645317b8e861123330b13e72954b88abb43a02b3fcf0cb15ffd5347c0",
}


def digest(tensors) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k].detach().cpu().contiguous().reshape(-1)
        h.update(f"{k} {t.dtype} {tuple(tensors[k].shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def rules_digest(rules) -> str:
    h = hashlib.sha256()
    for k in sorted(rules):
        kind, v = rules[k]
        h.update(f"{k} {kind} ".encode())
        if kind == "tensor":
            h.update(v.detach().float().contiguous().numpy().tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


@pytest.mark.parametrize("name", ["lc_eval", "c_stream"])
def test_committed_cells_read_as_before_through_their_detector_file(name):
    cell = spec.load_cell(name)
    det = cell.detector()
    assert det.__name__.endswith("UniBEV")
    path = os.path.join(spec.ROOT, cell.config["config_file"])
    # the whole of of_model, which the harness before detector files gave
    # as each configuration's expect
    assert det.of_model(det.build_port(path, "meta", False)) \
        == cell.config["expect"]
    meta = ref_build.build_meta(det.REFERENCE, path)
    assert rules_digest(weights._rules(meta, det.init_rules)) \
        == PARENT[f"rules {cell.config['name']}"]
    pool = traffic.make_pool(dict(cell.traffic, **SMALL), POOL_SEED, "cpu")
    assert [digest(b) for b in pool] \
        == PARENT[f"pool {cell.workload['traffic']}"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tag", ["lc", "c", "lc_fixed"])
def test_tiny_states_draw_as_before(tmp_path, tag, dtype):
    """``lc_fixed``: the fixed modality embeddings, whose rule the UniBEV
    file now adds."""
    from unibev_tpu_torch.flagship import tiny_model_cfg
    cfg = tiny_model_cfg(use_lidar=tag != "c")
    cfg.pop("dtype", None)
    if tag == "lc_fixed":
        cfg["pts_bbox_head"]["transformer"]["use_modal_embeds"] = "Fixed"
    path = os.path.join(str(tmp_path), f"tiny_{tag}.py")
    with open(path, "w") as f:
        f.write(f"model = dict(type='UniBEV', dtype='float32', **{cfg!r})\n")
    det = spec.load_detector(path)
    state = weights.make_state(ref_build.build_meta(det.REFERENCE, path),
                               STATE_SEED, "cpu", dtype, det.init_rules)
    assert digest(state) == PARENT[f"state {tag} {dtype}"]


# the stateful cell's limits: the port's CPU path is the reference's code
LIMITS = {"img_feat": 1e-4, "img_bev": 1e-4, "fused": 1e-4, "decoder": 1e-4,
          "refs": 1e-4, "cls": 1e-4, "box": 1e-4, "decode": 0,
          "history": 1e-4}
SEED = 2 ** 31 + 4321


def test_a_stateful_detector_from_test_files_alone_reads_correct(tmp_path):
    """The detector file, the port's class and the reference's twin live
    under ``tests/``; the harness finds them by the config's type."""
    cell = stateful_cell(tmp_path, LIMITS)
    assert cell.detector().__name__.endswith("TinyStatefulBEV")
    r = run.run_cell(cell, SEED, 0.1, False, device="cpu")
    assert r["correct"], r["compared"]
    assert set(r["numbers"]) == set(LIMITS)


@pytest.mark.parametrize("fault", [scene_never_starts, scene_always_starts])
def test_a_broken_scene_state_is_not_correct(tmp_path, fault):
    r = run.run_cell(stateful_cell(tmp_path, LIMITS), SEED, 0.1, False,
                     device="cpu", fault=fault)
    assert not r["correct"]
    assert r["numbers"]["history"] > 100 * LIMITS["history"]
    assert r["failed"] == r["attempted"] > 0


def test_a_check_that_does_not_replay_the_scene_fails_a_sound_port(
        tmp_path, monkeypatch):
    """Why the check replays: the reference run on the sampled calls alone
    has no history where the port rightly has one (the seed samples calls
    1 and 2, not the scene's first frame)."""
    seed = 2 ** 31 + 3
    cell = stateful_cell(tmp_path, LIMITS)
    t = cell.traffic
    assert check.sample_calls(torch.Generator().manual_seed(seed),
                              t["check_within"], traffic.distinct(t),
                              t["check_calls"]) == [1, 2]
    monkeypatch.setattr(traffic, "replay", lambda t, calls: sorted(calls))
    r = run.run_cell(cell, seed, 0.1, False, device="cpu")
    assert not r["correct"]
    assert r["numbers"]["history"] > 100 * LIMITS["history"]


# the harness's one table of hand kernels before their files
PARENT_PROFILED = {
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
}


def parent_category(kernel_name: str) -> str:
    n = kernel_name.lower()
    for frags, name in (
            (("lsa_kernel",), "K12 lsa"), (("msda_fwd",), "K1 msda_fwd"),
            (("dcn_fwd",), "K2 dcn_fwd"),
            (("dcn_im2col",), "dcn_im2col (the DCN backward's columns)"),
            (("msda_bwd",), "K3 msda_bwd"), (("dcn_bwd",), "K4 dcn_bwd"),
            (("scatter_add_rows",), "K5 scatter_add_rows"),
            (("sparse_inv_nbr",), "K8 sparse_inv_nbr"),
            (("sparse_wgrad",), "K9 sparse_conv_wgrad"),
            (("sparse_nbr",), "K6 sparse_nbr"),
            (("sparse_conv",), "K7 sparse_conv"),
            (("<10>", "<10,", "mark_points", "slot_points", "emit_voxels"),
             "K10 voxelize"),
            (("<11>", "<11,", "mark_rows", "mark_sites", "build_rows",
              "emit_sites"), "K11 active_set"),
            (("memcpy", "memset"), "copies and fills"),
            (("sort",), "sort (voxelizer, SCA top-K order)"),
            (("index", "scatter", "scan", "cum"),
             "index_add, index_copy, scatter, scans"),
            (("pool",), "max pooling (ResNet stem)"),
            (("fprop", "dgrad", "wgrad", "conv", "addpadding"),
             "convolution (cuDNN)"),
            (("gemm", "nvjet", "cutlass"), "matmul (cuBLAS)")):
        if any(f in n for f in frags):
            return name
    return "elementwise, norms and other"


def _port_kernel_names():
    """Every __global__ function of the port's CUDA sources, plain and as
    the profiler spells a launch; the two templates K10 and K11 share with
    the arguments each launches them with."""
    csrc = os.path.join(spec.ROOT, "unibev_tpu_torch", "csrc")
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu*")):
        with open(path) as f:
            names |= set(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                r"(\w+)", f.read()))
    assert "msda_fwd_kernel" in names and len(names) > 15
    out = set(names) | {f"void {n}(float const*, int)" for n in names}
    for n in ("fill_words", "scan_tiles"):
        assert n in names
        out |= {f"void {n}<10>(int)", f"void {n}<11>(int)",
                f"void {n}<10, 256>(int)", f"void {n}<11, 256>(int)"}
    return sorted(out)


def test_hand_kernel_files_hold_the_tables_as_they_were():
    kernels = trace.hand_kernels()
    assert {k: tuple((tuple(names), per) for names, per in v["profiled"])
            for k, v in kernels.items()} == PARENT_PROFILED
    names = _port_kernel_names() + [
        "ampere_bf16_s16816gemm", "nvjet_tst_128x256", "cudnn::fprop",
        "Memcpy DtoH", "at::native::index_elementwise_kernel",
        "at::native::max_pool2d", "radixSortKVInPlace",
        "void at::native::vectorized_elementwise_kernel<4>"]
    for n in names:
        assert trace.category(n) == parent_category(n), n
    # no name of the port's kernels matches two hand kernels' files
    for n in _port_kernel_names():
        hits = [k for k, v in kernels.items()
                if any(f in n.lower() for f in v["match"])]
        assert len(hits) <= 1, (n, hits)


def test_an_added_kernel_file_is_counted_and_named(tmp_path):
    here = os.path.join(str(tmp_path), "benchmark")
    os.makedirs(os.path.join(here, "kernels"))
    with open(os.path.join(here, "kernels", "tsa_fwd.json"), "w") as f:
        json.dump({"category": "K14 tsa_fwd", "match": ["tsa_fwd"],
                   "profiled": [[["tsa_fwd_kernel"], 2]]}, f)
    assert trace.hand_kernels(here)["tsa_fwd"]["profiled"] == [
        [["tsa_fwd_kernel"], 2]]
    assert trace.category("void tsa_fwd_kernel<4>()", here) == "K14 tsa_fwd"
    assert trace.category("void msda_fwd_kernel<4>()", here) \
        == "elementwise, norms and other"


HARNESS = ("run.py", "spec.py", "check.py", "trace.py", "spans.py",
           "traffic.py", "readers.py", "weights.py", "shapes.py", "faults.py",
           "calibrate.py", "train.py", "peaks.py", "__init__.py",
           os.path.join("reference", "build.py"))


def test_no_file_outside_the_detector_files_names_a_detector():
    """No harness file names a detector type, a module path of the UniBEV
    file's captures or layers, or a port module of its op sites; metric
    readers and work formulas neither."""
    det = spec.load_file("detectors", "UniBEV")
    words = {"UniBEV"}
    for table in (det.CAPTURES, det.FORCED):
        words |= {path for path, _ in table.values() if path}
    for paths in det.LAYERS.values():
        words |= set(paths)
    for sites in det.OPS.values():
        words |= {module for module, _ in sites}
    files = [os.path.join(run.HERE, f) for f in HARNESS]
    for kind in ("metrics", "work"):
        files += glob.glob(os.path.join(run.HERE, kind, "*.py"))
    for path in files:
        with open(path) as f:
            text = f.read()
        for w in sorted(words):
            assert not re.search(rf"(?<![\w.]){re.escape(w)}(?![\w])", text), \
                (os.path.relpath(path, run.HERE), w)
