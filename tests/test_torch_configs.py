"""The shipped config files, built with the port.

* Every file under ``configs/unibev/`` builds through
  ``flagship.build_model_from_config`` on the meta device (shapes and
  dtypes, no values), its input_modality merged as the JAX CLIs merge it,
  and its fusion deltas land where ``tests/test_configs.py`` finds them in
  the JAX package.
* The flagship, avg, cat_128 and dual-queries models carry exactly the
  reference checkpoint's keys and shapes, composed from
  ``tools/ref_inventory.py``, and load them with ``strict=True``.
* The config-built flagship is ``build_flagship()``: keys, shapes, compute
  dtype, SCA capacity, voxel and sparse capacities.
* ``loss_iou`` and ``iou_cost`` at a weight other than 0 raise.
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch

from unibev_tpu_torch.config.config import Config
from unibev_tpu_torch.flagship import (build_flagship, build_model,
                                       build_model_from_config,
                                       model_cfg_from_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from ref_inventory import (decoder_keys, encoder_keys,  # noqa: E402
                           flagship_state_dict, fpn_keys, head_keys,
                           resnet101_keys, second_keys, secondfpn_keys,
                           sparse_encoder_keys, transformer_top_keys)

CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs/unibev/**/*.py"),
                           recursive=True))
FLAGSHIP = os.path.join(REPO, "configs/unibev/unibev_nus_LC_cnw_256_modality_dropout.py")
AVG = os.path.join(REPO, "configs/unibev/unibev_nus_LC_avg_256_modality_dropout.py")
CAT = os.path.join(REPO, "configs/unibev/unibev_nus_LC_cat_128_modality_dropout.py")
DUAL = os.path.join(REPO, "configs/unibev/unibev_nus_LC_cnw_dual_queries_modality_dropout.py")


def test_config_files_exist():
    assert len(CONFIGS) == 17, CONFIGS


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_config_builds_model(path):
    model = build_model_from_config(path, "meta")
    modality = Config.fromfile(path).input_modality
    assert hasattr(model, "img_backbone") == modality["use_camera"]
    assert hasattr(model, "pts_backbone") == modality["use_lidar"]
    head = model.pts_bbox_head
    t = head.transformer
    assert head.query_embedding.weight.shape[0] == 900
    # the cat config names no dtype: float32, as the JAX package builds it
    want = torch.float32 if "cat_128" in path else torch.bfloat16
    assert model.compute_dtype == want
    assert {p.dtype for p in model.parameters()} == {want}
    if "cat_128" in path:
        assert t.fusion_method == "cat" and t.embed_dims == 128
        assert t.dec_dims == 256 and t.feature_norm is None
        assert t.img_bev_encoder.rebatch_k == 0          # dense camera SCA
    if "avg_256" in path:
        assert t.fusion_method == "avg" and t.feature_norm is None
    if "dual_queries" in path:
        assert t.dual_queries and head.dual_queries
    if "ablation_md" in path:
        cfg = Config.fromfile(path).model.pts_bbox_head.transformer
        drop = cfg["drop_modality"]
        assert model.drop_modality == (drop["dropout_prob"], drop["lidar_prob"])


def _backbones(sd, rng, C):
    resnet101_keys(sd, rng)
    fpn_keys(sd, rng, cout=C)
    sparse_encoder_keys(sd, rng)
    second_keys(sd, rng)
    secondfpn_keys(sd, rng, cout=(C // 2, C // 2))


def _inventory(C=256, feature_norm="ChannelNormWeights", scale=1, dual=False):
    """The reference checkpoint's keys for the LC model at width C (the
    decoder at scale * C), from tools/ref_inventory.py."""
    rng = np.random.RandomState(0)
    sd = {}
    _backbones(sd, rng, C)
    transformer_top_keys(sd, rng, C=C, feature_norm=feature_norm,
                         scale_factor=scale)
    encoder_keys(sd, rng, "img", C=C)
    encoder_keys(sd, rng, "pts", C=C)
    decoder_keys(sd, rng, C=C * scale)
    head_keys(sd, rng, C=C, scale_factor=scale, dual_queries=dual)
    return sd


INVENTORIES = {
    "flagship": (FLAGSHIP, flagship_state_dict),
    "avg": (AVG, lambda: _inventory(feature_norm=None)),
    "cat_128": (CAT, lambda: _inventory(C=128, feature_norm=None, scale=2)),
    "dual_queries": (DUAL, lambda: _inventory(dual=True)),
}


@pytest.mark.parametrize("name", list(INVENTORIES))
def test_reference_keys_load_strictly(name):
    path, inventory = INVENTORIES[name]
    model = build_model_from_config(path, "meta")
    sd = inventory()
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(np.shape(v)) for k, v in sd.items()}
    dtype = model.compute_dtype
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)).to(
        torch.int64 if k.endswith("num_batches_tracked") else dtype)
        for k, v in sd.items()}, strict=True, assign=True)
    assert not any(p.is_meta for p in model.parameters())


def test_composed_flagship_inventory_is_the_tools():
    want = flagship_state_dict()
    got = _inventory()
    assert {k: np.shape(v) for k, v in got.items()} == {
        k: np.shape(v) for k, v in want.items()}


def test_config_model_equals_flagship_model():
    """The port's counterpart of tests/test_configs.py's test of the same
    name: the flagship file builds the model build_flagship() builds."""
    cfg_model = build_model_from_config(FLAGSHIP, "meta")
    ref_model = build_flagship(device="meta")
    assert cfg_model.compute_dtype == ref_model.compute_dtype == torch.bfloat16
    got = {k: (tuple(v.shape), v.dtype) for k, v in cfg_model.state_dict().items()}
    assert got == {k: (tuple(v.shape), v.dtype)
                   for k, v in ref_model.state_dict().items()}
    for m in (cfg_model, ref_model):
        assert m.pts_bbox_head.transformer.img_bev_encoder.rebatch_k == 10240
        assert m.pts_middle_encoder.capacities == (120000, 90000, 60000, 40000)
        assert m.max_voxels == 120000
        assert m.drop_modality == (0.5, 0.5)
        assert m.pts_bbox_head.transformer.feature_norm == "ChannelNormWeights"


def test_input_modality_merges_and_model_wins():
    cfg = model_cfg_from_config(os.path.join(REPO, "configs/unibev/unibev_nus_L.py"))
    assert (cfg["use_lidar"], cfg["use_camera"]) == (True, False)
    c = Config.fromfile(FLAGSHIP)
    c.merge_from_dict({"input_modality.use_camera": False,
                       "model.use_camera": True})
    assert model_cfg_from_config(c)["use_camera"] is True
    assert model_cfg_from_config(Config.fromfile(CAT))["dtype"] is torch.float32


@pytest.mark.parametrize("where,weight", [
    ("loss_iou", 1.0), ("loss_iou", None), ("loss_iou", 0.5),
    ("iou_cost", 2.0), ("iou_cost", None)])
def test_iou_terms_above_zero_raise(where, weight):
    """The reference configs' GIoU loss and IoU cost are placeholders at
    weight 0; any other weight (mmdet's default 1.0 where none is given)
    raises instead of being dropped."""
    cfg = model_cfg_from_config(FLAGSHIP)
    head = dict(cfg["pts_bbox_head"])
    term = dict(type="GIoULoss") if where == "loss_iou" else dict(type="IoUCost")
    if weight is not None:
        term["loss_weight" if where == "loss_iou" else "weight"] = weight
    if where == "loss_iou":
        head["loss_iou"] = term
    else:
        assigner = dict(cfg["train_cfg"]["pts"]["assigner"], iou_cost=term)
        cfg["train_cfg"] = dict(pts=dict(assigner=assigner))
    cfg["pts_bbox_head"] = head
    with pytest.raises(ValueError, match="iou"):
        build_model(cfg, "meta")
