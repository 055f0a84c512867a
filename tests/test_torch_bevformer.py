"""The port's BEVFormer against the benchmark's plain reference
(``benchmark/reference``, written from the published code) at a tiny size:
``flagship.tiny_bevformer_cfg`` (2 cameras at 64 x 96, two FPN levels, a
20 x 20 BEV, 2 encoder and 2 decoder layers, dims 32), seeded random
weights drawn once (``benchmark.weights``) and loaded into both, frames of
a scene that turns (``benchmark.traffic``).

Per frame, the aligned previous map the temporal self-attention reads, the
encoder's output (the next frame's history) and every decoder layer's class
and box outputs agree within 1e-5 relative L2: on the CPU both run the same
float32 ops, the port's plain versions of its kernels.  With B = 2 each
slot keeps its own scene, against a B = 1 reference of each.  On a card the
port runs kernel K1 in bfloat16, held at bfloat16's rounding.
"""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import spec, traffic, weights
from benchmark.reference import build as ref_build
from unibev_tpu_torch.flagship import tiny_bevformer_cfg

SEED = 2 ** 31 + 11
# five frames of a scene that turns 10 degrees a frame from its second
SCENE = {"frames": 7, "dt_s": 0.5, "speed_mps": 8.0, "yaw_rate_dps": 20.0,
         "straight_share": 0.2, "start_range_m": 1000.0}
TRAFFIC = {"kind": "predict", "batch": 1, "pool": 7, "inputs": ["img"],
           "cameras": 2, "height": 64, "width": 96, "img_hw": [64, 96],
           "focal": 60.0, "gt": 6, "gt_valid": 4, "gt_xy": 5.0,
           "classes": 10, "scene": SCENE}
REL = 1e-5
# bfloat16's unit roundoff 2 ** -8 and a layer's few roundings of it
BF16_REL = 0.05


def _write(directory, dtype: str) -> str:
    path = os.path.join(str(directory), f"tiny_bevformer_{dtype}.py")
    with open(path, "w") as f:
        f.write(f"model = dict(type='BEVFormer', dtype={dtype!r}, "
                f"**{tiny_bevformer_cfg()!r})\n")
    return path


@pytest.fixture(scope="module")
def config(tmp_path_factory) -> str:
    return _write(tmp_path_factory.mktemp("bevformer"), "float32")


def _models(path, device="cpu"):
    """The port of the config file at ``path`` (in its dtype) and the
    float32 state both models load."""
    det = spec.load_detector(path)
    meta = ref_build.build_meta(det.REFERENCE, path)
    state = weights.make_state(meta, SEED, "cpu", torch.float32,
                               det.init_rules)
    port = det.build_port(path, "meta", False).to_empty(device=device)
    port.load_state_dict(state)
    return port, det, state


def _reference(det, path, state, device="cpu"):
    return ref_build.build(det.REFERENCE, path, state, device)


def _aligned(model):
    """Keep the aligned previous map of each forward of ``model``."""
    kept = []
    model.pts_bbox_head.transformer.align.register_forward_hook(
        lambda m, args, out: kept.append(out[0]))
    return kept


def _rel(got, want) -> float:
    g, w = got.double().flatten(), want.double().flatten()
    return float((g - w).norm() / w.norm().clamp(min=1e-30))


def _frames(batch: int, device="cpu"):
    """Frames 0-4 of each vehicle's scene, then a new scene (frames 0-1 of
    the pool's second pass, under other scene ids)."""
    pool = traffic.make_pool(dict(TRAFFIC, batch=batch), SEED, device)
    F = SCENE["frames"]
    return [pool[k] for k in range(5)] + [pool[F], pool[F + 1]]


def _compare(port_out, ref_out, port_prev, ref_prev, rel):
    assert bool(port_out["history"].cpu().item()) \
        == bool(ref_out["history"].cpu().item())
    if ref_prev is not None:
        assert _rel(port_prev, ref_prev) <= rel
    assert _rel(port_out["bev_embed"], ref_out["bev_embed"]) <= rel
    for k in ("all_cls_scores", "all_bbox_preds"):
        for lvl in range(port_out[k].shape[0]):
            assert _rel(port_out[k][lvl], ref_out[k][lvl]) <= rel, (k, lvl)


def test_a_turning_scene_and_a_new_one_match_the_reference(config):
    port, det, state = _models(config)
    ref = _reference(det, config, state)
    got, want = _aligned(port), _aligned(ref)
    history, frames = [], []
    with torch.no_grad():
        for batch in _frames(1):
            p, r = port(batch), ref(batch)
            history.append(bool(p["history"][0]))
            frames.append(int(p["scene_frame"][0]))
            assert int(r["scene_frame"][0]) == frames[-1]
            _compare(p, r, got[-1], want[-1], REL)
    assert history == [False, True, True, True, True, False, True]
    assert frames == [0, 1, 2, 3, 4, 0, 1]


def test_predict_decodes_the_forward_and_reports_history(config):
    port, det, state = _models(config)
    twin, _, _ = _models(config)
    frames = _frames(1)[:3]
    with torch.no_grad():
        for batch in frames:
            out = port.predict(batch)
            want = twin.pts_bbox_head.get_bboxes(twin(batch))
            for k in ("bboxes", "scores", "labels", "valid"):
                assert torch.equal(out[k], want[k]), k
    assert out["history"].tolist() == [True]
    assert out["scene_frame"].tolist() == [2]
    assert int(out["sca_overflow"]) == 0
    port.history.reset()
    out = port.predict(frames[2])
    assert out["history"].tolist() == [False]
    assert out["scene_frame"].tolist() == [0]


def test_each_slot_of_a_batch_keeps_its_own_scene(config):
    """B = 2: slot 1 starts a new scene at frame 3 while slot 0 goes on;
    each slot against a B = 1 reference of its own."""
    port, det, state = _models(config)
    refs = [_reference(det, config, state) for _ in range(2)]
    got = _aligned(port)
    want = [_aligned(r) for r in refs]
    frames = _frames(2)[:5]
    seen, counted = [], []
    with torch.no_grad():
        for i, batch in enumerate(frames):
            if i >= 3:
                batch = dict(batch, scene_id=batch["scene_id"]
                             + torch.tensor([0, 100]))
            p = port(batch)
            seen.append(p["history"].tolist())
            counted.append(p["scene_frame"].tolist())
            for b, ref in enumerate(refs):
                one = {k: v[b:b + 1] for k, v in batch.items()}
                r = ref(one)
                pb = {k: (v[:, b:b + 1] if k.startswith("all_") else
                          v[b:b + 1]) for k, v in p.items()
                      if k in ("all_cls_scores", "all_bbox_preds",
                               "bev_embed", "history")}
                _compare(pb, r, got[-1][b:b + 1], want[b][-1], REL)
    assert seen == [[False, False], [True, True], [True, True],
                    [True, False], [True, True]]
    assert counted == [[0, 0], [1, 1], [2, 2], [3, 0], [4, 1]]


@pytest.mark.cuda
def test_the_card_matches_the_reference_at_bf16(config):
    """K1 (and the port's other kernels) in bfloat16 on the card against
    the float32 reference, TF32 off; the tolerance is bfloat16's, a few
    roundings of 2 ** -8 through a layer, carried frame to frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from unibev_tpu_torch.ops import _build
    path = _write(os.path.dirname(config), "bfloat16")
    port, det, state = _models(path, "cuda")
    assert {p.dtype for p in port.parameters()} == {torch.bfloat16}
    ref = _reference(det, path, state, "cuda")
    got, want = _aligned(port), _aligned(ref)
    before = _build.launches.get("msda_fwd", 0)
    with torch.no_grad():
        for batch in _frames(1, "cuda"):
            p, r = port(batch), ref(batch)
            _compare(p, r, got[-1], want[-1], BF16_REL)
    # per frame: 2 TSA, 2 SCA and 2 decoder layers
    assert _build.launches["msda_fwd"] - before == 7 * 6
