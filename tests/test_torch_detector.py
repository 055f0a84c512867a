"""The slice end to end: UniBEV predict, JAX against the port.

The tiny model of tests/test_detector.py (2 cameras, 8x8 BEV, depth-50
backbone with DCN in stage 4; with LiDAR a [25, 32, 32] voxel grid whose
first strided conv overflows its capacity) with the camera cross-attention
rebatched to 16 queries per camera (the geometry gives 12 hits per camera,
so the top-K path runs and drops nothing).  The C-only model, and the LC
model in LC, L (no ``img`` in the batch) and C (no ``points``) mode.  The
JAX model's variables (running statistics included) are perturbed, carried
into the port with ``jax_to_state_dict`` and loaded with ``strict=True``.

Tolerance: atol/rtol 1e-4 on the head outputs and the decoded scores and
boxes (f32 through the depth-50 backbone, the sparse encoder, one encoder
layer per modality and two decoder layers); labels and validity exactly.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from unibev_tpu.models.detectors.unibev import UniBEV as JaxUniBEV

from unibev_tpu.flagship import flagship_model_cfg as jax_flagship_model_cfg

from test_detector import tiny_batch as jax_tiny_batch
from test_detector import tiny_model_cfg as jax_tiny_model_cfg
from torch_port_utils import perturb, t
from unibev_tpu_torch.flagship import (build_model, flagship_model_cfg,
                                       tiny_batch, tiny_model_cfg)
from unibev_tpu_torch.registry import DETECTORS
from unibev_tpu_torch.utils.convert_jax import jax_to_state_dict

TOL = dict(atol=1e-4, rtol=1e-4)


def test_flagship_cfg_is_the_jax_packages():
    got = flagship_model_cfg(use_lidar=False)
    want = jax_flagship_model_cfg(use_lidar=False)
    assert got.pop("dtype") == torch.bfloat16 and want.pop("dtype") == jnp.bfloat16
    assert got == want


def test_registry_builds_the_tiny_model():
    model = DETECTORS.build(dict(type="UniBEV", **tiny_model_cfg()))
    assert sorted(model.state_dict()) == sorted(
        build_model(tiny_model_cfg(), "cpu").state_dict())


def test_tiny_cfg_is_the_camera_part_of_the_tests_config():
    want = jax_tiny_model_cfg(use_lidar=False)
    want["pts_bbox_head"]["transformer"]["img_encoder"]["transformerlayers"][
        "attn_cfgs"][1]["rebatch_k"] = 16
    del want["pts_bbox_head"]["transformer"]["pts_encoder"]
    got = tiny_model_cfg()
    assert got == {k: want[k] for k in got}


def test_tiny_batch_is_the_tests_camera_batch():
    want = jax_tiny_batch(np.random.RandomState(0))
    got = tiny_batch(np.random.RandomState(0))
    for k in ("img", "lidar2img"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.fixture(scope="module")
def both_models():
    cfg = tiny_model_cfg()
    jbatch = jax_tiny_batch(np.random.RandomState(0))
    jbatch = dict(img=jbatch["img"], lidar2img=jbatch["lidar2img"])
    jm = JaxUniBEV(**cfg)
    variables = perturb(jm.init(
        dict(params=jax.random.PRNGKey(0), gridmask=jax.random.PRNGKey(1)),
        jbatch, train=False), scale=0.01)
    tm = build_model(cfg, "cpu", seed=1)
    tm.load_state_dict(jax_to_state_dict(variables), strict=True)
    tbatch = {k: t(v) for k, v in jbatch.items()}
    return jm, variables, jbatch, tm, tbatch


def test_head_outputs_match(both_models):
    jm, variables, jbatch, tm, tbatch = both_models
    want = jm.apply(variables, jbatch, train=False)
    with torch.inference_mode():
        got = tm(tbatch)
    for k in ("all_cls_scores", "all_bbox_preds"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def test_predict_matches(both_models):
    jm, variables, jbatch, tm, tbatch = both_models
    want, state = jm.apply(variables, jbatch, method=JaxUniBEV.predict,
                           mutable=["intermediates"])
    enc = state["intermediates"]["pts_bbox_head"]["transformer"]["img_encoder"]
    (overflow,) = enc["sca_topk_overflow"]
    got = tm.predict(tbatch)
    assert int(got["sca_overflow"]) == 0 == int(np.max(overflow))
    assert got["bboxes"].shape == (1, 16, 9)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("scores", "bboxes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def test_lc_flagship_cfg_is_the_jax_packages():
    got = flagship_model_cfg()
    want = jax_flagship_model_cfg(fp8_tables=False)
    assert got.pop("dtype") == torch.bfloat16 and want.pop("dtype") == jnp.bfloat16
    assert got == want


def test_tiny_lc_cfg_is_the_tests_config():
    want = jax_tiny_model_cfg(use_lidar=True)
    want["pts_bbox_head"]["transformer"]["img_encoder"]["transformerlayers"][
        "attn_cfgs"][1]["rebatch_k"] = 16
    assert tiny_model_cfg(use_lidar=True) == want


def test_tiny_batch_points_are_the_tests():
    want = jax_tiny_batch(np.random.RandomState(0))
    got = tiny_batch(np.random.RandomState(0))
    for k in ("points", "points_mask", "gt_bboxes", "gt_labels", "gt_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


MODES = {"LC": ("img", "points", "points_mask", "lidar2img"),
         "L": ("points", "points_mask", "lidar2img"),
         "C": ("img", "lidar2img")}


@pytest.fixture(scope="module")
def lc_models():
    """The tiny LC model in both packages, and per mode the JAX head outputs
    and decoded boxes (one jit per mode) with the port's batch."""
    cfg = tiny_model_cfg(use_lidar=True)
    jbatch = jax_tiny_batch(np.random.RandomState(0))
    jm = JaxUniBEV(**cfg)
    variables = perturb(jax.jit(functools.partial(jm.init, train=False))(
        dict(params=jax.random.PRNGKey(0), gridmask=jax.random.PRNGKey(1)),
        {k: jbatch[k] for k in MODES["LC"]}), scale=0.01)
    tm = build_model(cfg, "cpu", seed=1)
    tm.load_state_dict(jax_to_state_dict(variables), strict=True)

    @jax.jit
    def run(v, b):
        preds = jm.apply(v, b, train=False)
        boxes, state = jm.apply(v, b, method=JaxUniBEV.predict,
                                mutable=["intermediates"])
        return preds, boxes, state

    out = {}
    for mode, keys in MODES.items():
        jb = {k: jbatch[k] for k in keys}
        out[mode] = (run(variables, jb), {k: t(v) for k, v in jb.items()})
    return tm, out


@pytest.mark.parametrize("mode", list(MODES))
def test_lc_model_head_outputs_match(lc_models, mode):
    tm, out = lc_models
    (want, _, _), tbatch = out[mode]
    with torch.inference_mode():
        got = tm(tbatch)
    for k in ("all_cls_scores", "all_bbox_preds"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
    if mode != "C":
        # the first strided conv of the tiny batch overflows its capacity
        assert int(got["sparse_overflow"][0]) > 0


@pytest.mark.parametrize("mode", list(MODES))
def test_lc_model_predict_matches(lc_models, mode):
    tm, out = lc_models
    (_, want, state), tbatch = out[mode]
    got = tm.predict(tbatch)
    assert got["bboxes"].shape == (1, 16, 9)
    assert int(got["sca_overflow"]) == 0
    if mode != "L":
        enc = state["intermediates"]["pts_bbox_head"]["transformer"]["img_encoder"]
        assert int(np.max(enc["sca_topk_overflow"][0])) == 0
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("scores", "bboxes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
