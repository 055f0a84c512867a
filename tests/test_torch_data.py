"""The data layer, JAX package against the port: every pipeline transform,
NuScenesDataset on the on-disk fake nuScenes tree, SyntheticNuScenes,
collate, the loader's order and per-epoch augmentations, and the native
host library.

Everything here is numpy on the host, so every comparison is exact: the
same arrays with the same dtypes, and the per-sample generators left in the
same state (the port draws what JAX draws, in the same order).  One
exception: ``transform_points`` of the native library, which the JAX
package's Makefile builds with ``-march=native`` (the compiler may fuse
``R x + t`` into FMAs) and the port with ``-O3`` alone: there 1 float32
rounding (rtol 1e-6).
"""

import copy
import os
import os.path as osp

import numpy as np
import pytest
import torch

from unibev_tpu.data import native as jax_native
from unibev_tpu.data import nuscenes_dataset as jax_ds
from unibev_tpu.data import pipelines as jax_pipelines  # noqa: F401 (registers)
from unibev_tpu.data.loader import DataLoader as JaxDataLoader
from unibev_tpu.registry import DATASETS as JAX_DATASETS
from unibev_tpu.registry import PIPELINES as JAX_PIPELINES
from unibev_tpu.registry import build_from_cfg

from test_radar import write_pcd
from torch_port_utils import assert_same, fake_nuscenes_tree
from unibev_tpu_torch.config.config import Config
from unibev_tpu_torch.data import native
from unibev_tpu_torch.data import nuscenes_dataset as port_ds
from unibev_tpu_torch.data.loader import DataLoader
from unibev_tpu_torch.registry import DATASETS, PIPELINES

PC_RANGE = [-9.6, -9.6, -2.0, 9.6, 9.6, 2.0]
CLASSES = list(jax_ds.DEFAULT_CLASSES)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    return root, fake_nuscenes_tree(root)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """One results dict as the dataset hands it to the pipeline: files for
    the loaders (a .bin cloud, two sweeps, two jpgs) and in-memory points,
    images, boxes (some out of range, labels -1 and 12) and matrices."""
    from PIL import Image
    d = tmp_path_factory.mktemp("raw")
    rng = np.random.RandomState(0)
    cloud = (rng.randn(300, 5) * 6).astype(np.float32)
    cloud.tofile(d / "pts.bin")
    sweeps = []
    for s in range(2):
        (rng.randn(100, 5) * 6).astype(np.float32).tofile(d / f"sweep{s}.bin")
        R = np.linalg.qr(rng.randn(3, 3))[0]
        sweeps.append(dict(data_path=str(d / f"sweep{s}.bin"),
                           sensor2lidar_rotation=R.tolist(),
                           sensor2lidar_translation=rng.randn(3).tolist(),
                           timestamp=10.0 - 0.05 * (s + 1)))
    files = []
    for c in range(2):
        img = (rng.rand(30, 44, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(d / f"cam{c}.jpg")
        files.append(str(d / f"cam{c}.jpg"))
    boxes = rng.randn(6, 9).astype(np.float32)
    boxes[:, :2] *= 8
    radar_sweeps = []
    for s in range(3):
        pcd = np.zeros((30 + 20 * s, 18), np.float32)
        pcd[:, :10] = rng.randn(len(pcd), 10) * 10
        write_pcd(d / f"radar{s}.pcd", pcd)
        radar_sweeps.append(dict(data_path=str(d / f"radar{s}.pcd"),
                                 sensor2lidar_rotation=np.linalg.qr(
                                     rng.randn(3, 3))[0].tolist(),
                                 sensor2lidar_translation=rng.randn(3).tolist(),
                                 timestamp=10.0 - 0.07 * s))
    return dict(
        pts_filename=str(d / "pts.bin"), sweeps=sweeps, timestamp=10.0,
        radar_info=dict(RADAR_FRONT=radar_sweeps[:2],
                        RADAR_BACK_LEFT=radar_sweeps[2:]),
        img_filename=files, sample_idx="tok0", box_type_3d="LiDAR",
        points=cloud.copy(),
        img=[(rng.rand(30, 44, 3) * 255).astype(np.float32) for _ in range(2)],
        lidar2img=[rng.randn(4, 4).astype(np.float32) for _ in range(2)],
        gt_bboxes_3d=boxes, gt_labels_3d=np.array([0, 3, -1, 12, 9, 1]),
        ann_info=dict(gt_bboxes_3d=boxes[:4],
                      gt_labels_3d=np.array([1, 2, 3, 4])))


NORMALIZE = dict(type="NormalizeMultiviewImage",
                 mean=[103.530, 116.280, 123.675], std=[1.0, 2.0, 0.5],
                 to_rgb=False)
COLLECT = dict(type="CustomCollect3D",
               keys=["points", "img", "gt_bboxes_3d", "gt_labels_3d"])

# every transform the JAX package registers, with the keys of ``raw`` it
# reads
TRANSFORMS = {
    "LoadPointsFromFile": (dict(load_dim=5, use_dim=4), ("pts_filename",)),
    "LoadPointsFromMultiSweeps": (dict(sweeps_num=2),
                                  ("points", "sweeps", "timestamp")),
    "LoadPointsFromMultiSweeps, no sweeps": (
        dict(type="LoadPointsFromMultiSweeps", sweeps_num=3), ("points",)),
    "LoadAnnotations3D": (dict(), ("ann_info",)),
    "LoadMultiViewImageFromFiles": (dict(to_float32=True), ("img_filename",)),
    "PointsRangeFilter": (dict(point_cloud_range=PC_RANGE), ("points",)),
    "ObjectRangeFilter": (dict(point_cloud_range=PC_RANGE),
                          ("gt_bboxes_3d", "gt_labels_3d")),
    "ObjectNameFilter": (dict(classes=CLASSES),
                         ("gt_bboxes_3d", "gt_labels_3d")),
    "PointShuffle": (dict(), ("points",)),
    "NormalizeMultiviewImage": (NORMALIZE, ("img",)),
    "NormalizeMultiviewImage, to_rgb": (dict(NORMALIZE, to_rgb=True),
                                        ("img",)),
    "PadMultiViewImage": (dict(size_divisor=32), ("img",)),
    "PadMultiViewImage, size": (dict(type="PadMultiViewImage",
                                     size=(40, 64)), ("img",)),
    "PhotoMetricDistortionMultiViewImage": (dict(), ("img",)),
    "RandomScaleImageMultiViewImage": (dict(scales=[0.5, 0.75, 1.0]),
                                       ("img", "lidar2img")),
    "MultiScaleFlipAug3D": (dict(img_scale=(44, 30), flip=True, transforms=[
        dict(type="PointsRangeFilter", point_cloud_range=PC_RANGE),
        NORMALIZE, dict(type="PadMultiViewImage", size_divisor=32),
        dict(type="DefaultFormatBundle3D", with_label=False),
        dict(type="CustomCollect3D", keys=["points", "img"])]),
        ("points", "img", "lidar2img", "sample_idx")),
    "DefaultFormatBundle3D": (dict(), ("img",)),
    "CustomDefaultFormatBundle3D": (dict(), ("img",)),
    "Collect3D": (dict(keys=COLLECT["keys"]), None),
    "CustomCollect3D": (COLLECT, None),
    "PadShapes": (dict(max_points=256, max_gt=4),
                  ("points", "gt_bboxes_3d", "gt_labels_3d")),
    "LoadRadarPointsFromMultiSweeps": (dict(sweeps_num=2, max_num=96),
                                       ("radar_info", "timestamp")),
}


def test_every_jax_transform_is_ported():
    names = {n.split(",")[0] for n in TRANSFORMS}
    assert set(JAX_PIPELINES._module_dict) == names == set(PIPELINES._module_dict)


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches(raw, name):
    cfg, keys = TRANSFORMS[name]
    cfg = dict(cfg)
    cfg.setdefault("type", name)
    results = {k: raw[k] for k in keys} if keys else dict(raw)
    outs = []
    for build in (lambda c: build_from_cfg(c, JAX_PIPELINES), PIPELINES.build):
        r = copy.deepcopy(results)
        r["rng"] = np.random.default_rng(3)
        outs.append(build(copy.deepcopy(cfg))(r))
    assert_same(outs[1], outs[0])


def _config(path):
    return Config.fromfile(path)


@pytest.mark.parametrize("split", ["train", "test"])
def test_nuscenes_dataset_items_match(tree, split):
    _, cfg_path = tree
    dcfg = dict(_config(cfg_path).data[split])
    jax = build_from_cfg(copy.deepcopy(dcfg), JAX_DATASETS)
    port = DATASETS.build(copy.deepcopy(dcfg))
    assert len(port) == len(jax) and len(port) > 0
    for epoch in (0, 1):
        jax.epoch = port.epoch = epoch
        for i in range(len(port)):
            want, got = jax[i], port[i]
            assert_same(got, want, f"{split} epoch {epoch} item {i}")
    if split == "train":
        assert set(got) >= {"points", "points_mask", "img", "lidar2img",
                            "gt_bboxes", "gt_labels", "gt_valid"}
        for i in range(len(port)):
            assert_same(port.get_ann_info(i), jax.get_ann_info(i))


def test_synthetic_nuscenes_matches():
    kw = dict(length=3, num_cams=2, img_hw=(32, 48), max_points=256,
              max_gt=8, seed=5)
    jax, port = jax_ds.SyntheticNuScenes(**kw), port_ds.SyntheticNuScenes(**kw)
    assert len(port) == len(jax) == 3
    for i in range(3):
        assert_same(port[i], jax[i], f"item {i}")


def test_collate_matches():
    ds = port_ds.SyntheticNuScenes(length=3, num_cams=2, img_hw=(16, 24),
                                   max_points=64, max_gt=4)
    samples = [ds[i] for i in range(3)]
    got = port_ds.collate(samples)
    assert_same(got, jax_ds.collate(samples))
    assert got["img"].shape == (3, 2, 16, 24, 3)


class _Indices:
    """A dataset whose items are their indices."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {"idx": np.array(i, np.int64),
                "img_metas": dict(sample_idx=i)}


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_order_matches(workers, drop_last):
    kw = dict(batch_size=3, shuffle=True, seed=5, drop_last=drop_last)
    jax = JaxDataLoader(_Indices(), num_workers=0, **kw)
    port = DataLoader(_Indices(), num_workers=workers, **kw)
    assert len(port) == len(jax)
    for epoch in range(2):
        want = [b["idx"].tolist() for b in jax]
        got = [b["idx"].tolist() for b in port]
        assert got == want, epoch
    assert port.epoch == 2


def test_loader_epochs_draw_fresh_augmentations(tree):
    """Two epochs of the train split (PointShuffle draws per sample) through
    the port's loader with 2 worker processes: epoch 1 differs from epoch 0
    and both equal the JAX loader's epochs."""
    _, cfg_path = tree
    dcfg = dict(_config(cfg_path).data["train"])
    jax = JaxDataLoader(build_from_cfg(copy.deepcopy(dcfg), JAX_DATASETS),
                        batch_size=1, num_workers=0, seed=2)
    port = DataLoader(DATASETS.build(copy.deepcopy(dcfg)), batch_size=1,
                      num_workers=2, seed=2)
    points = {}
    for epoch in range(2):
        for jb, pb in zip(jax, port):
            token = pb["img_metas"][0]["sample_idx"]
            assert token == jb["img_metas"][0]["sample_idx"]
            assert isinstance(pb["points"], torch.Tensor)
            np.testing.assert_array_equal(pb["points"].numpy(), jb["points"])
            np.testing.assert_array_equal(pb["img"].numpy(), jb["img"])
            points[epoch, token] = pb["points"].numpy()
    tokens = {t for _, t in points}
    assert len(tokens) == 3
    for t in tokens:
        assert not np.array_equal(points[0, t], points[1, t]), t
        # the same points, in another order
        assert sorted(map(tuple, points[0, t][0])) == sorted(
            map(tuple, points[1, t][0])), t


@pytest.fixture(scope="module")
def jax_lib():
    if jax_native._load_lib() is None:
        pytest.skip("the JAX package's native library did not build")


def test_native_library_builds_outside_csrc():
    path = native.library_path()
    native.lib()
    assert osp.isfile(path)
    assert osp.dirname(path) == native.BUILD_DIR
    assert not path.startswith(osp.dirname(native.SOURCE) + os.sep)


def test_native_load_points_matches(jax_lib, tmp_path):
    pts = np.random.RandomState(0).randn(1000, 5).astype(np.float32)
    p = str(tmp_path / "pts.bin")
    pts.tofile(p)
    for cap in (2000, 100):
        got = native.load_points_bin(p, max_points=cap, dim=5)
        assert_same(got, jax_native.load_points_bin(p, max_points=cap, dim=5))
    with pytest.raises(FileNotFoundError):
        native.load_points_bin(str(tmp_path / "missing.bin"), 10)


def test_native_transform_points_matches(jax_lib):
    rng = np.random.RandomState(1)
    pts = rng.randn(500, 5).astype(np.float32)
    R = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    t = rng.randn(3).astype(np.float32)
    got = native.transform_points(pts.copy(), R, t)
    want = jax_native.transform_points(pts.copy(), R, t)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[:, 3:], pts[:, 3:])


@pytest.mark.parametrize("shuffle", [True, False])
def test_native_range_filter_shuffle_pad_matches(jax_lib, shuffle):
    pts = (np.random.RandomState(2).randn(5000, 5) * 40).astype(np.float32)
    for cap in (4096, 1000):
        got = native.range_filter_shuffle_pad(pts, (-54, -54, -5, 54, 54, 3),
                                              cap, shuffle=shuffle, seed=7)
        want = jax_native.range_filter_shuffle_pad(
            pts, (-54, -54, -5, 54, 54, 3), cap, shuffle=shuffle, seed=7)
        assert_same(list(got), list(want))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_native_normalize_pad_image_matches(jax_lib, dtype):
    img = np.random.RandomState(3).randint(0, 255, (90, 16, 3)).astype(dtype)
    mean, std = [103.53, 116.28, 123.675], [1.0, 2.0, 0.5]
    for to_rgb in ((False, True) if dtype == np.uint8 else (False,)):
        got = native.normalize_pad_image(img, mean, std, to_rgb, (96, 32))
        assert_same(got, jax_native.normalize_pad_image(img, mean, std,
                                                        to_rgb, (96, 32)))
