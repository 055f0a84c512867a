"""The radar branch, the port against the JAX package.

* the data layer, exact: a nuScenes radar .pcd (binary and ascii) through
  ``read_radar_pcd``; ``LoadRadarPointsFromMultiSweeps`` over two radars
  with rotated, translated sweeps, in its pad, drop and empty cases, drawing
  from the same per-sample generator; ``RadarPoints`` rotate, flip, scale;
* ``PillarFeatureNet`` and ``PointPillarsScatter`` on a non-square grid
  (H = 5 rows of y, W = 7 columns of x) at batch 2 with masked pillars,
  outputs and gradients against ``jax.vjp`` of the JAX modules;
* the tiny RC model of ``tests/test_radar.py`` (the camera model with radar
  on a 16x16 pillar grid), its perturbed JAX variables carried over by
  ``jax_to_state_dict``: RC, R (no ``img``) and C (no ``radar``) predict,
  head outputs and decoded boxes; the losses and every gradient in eval
  mode with gradients on, against ``jax.grad`` of the JAX ``train=False``
  loss;
* a batch with LiDAR and radar raises; the full-width RC model builds on
  the meta device with the shapes of its 180x180 pillar grid.

Tolerances (PERF.md section 2): data exactly; module outputs 1e-5 and
gradients atol 1e-5 / rtol 1e-4; model outputs 1e-4; losses 1e-5
relative; model gradients 1e-3 of each parameter's largest.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from unibev_tpu.data.radar import (LoadRadarPointsFromMultiSweeps as
                                   JaxLoadRadar, RadarPoints as JaxRadarPoints,
                                   read_radar_pcd as jax_read_radar_pcd)
from unibev_tpu.models.detectors.unibev import UniBEV as JaxUniBEV
from unibev_tpu.models.radar import (PillarFeatureNet as JaxPFN,
                                     PointPillarsScatter as JaxScatter)

from test_radar import write_pcd
from torch_port_utils import perturb, port_state, t
from unibev_tpu_torch.data.radar import (RADAR_FIELDS, LoadRadarPointsFromMultiSweeps,
                                         RadarPoints, read_radar_pcd)
from unibev_tpu_torch.flagship import (RADAR_POINTS, build_model,
                                       flagship_model_cfg, synthetic_batch,
                                       tiny_batch, tiny_model_cfg)
from unibev_tpu_torch.models.detectors.unibev import UniBEV
from unibev_tpu_torch.models.radar import PillarFeatureNet, PointPillarsScatter
from unibev_tpu_torch.registry import (MIDDLE_ENCODERS, PIPELINES,
                                       VOXEL_ENCODERS)
from unibev_tpu_torch.utils.convert_jax import jax_to_state_dict

KEY = jax.random.PRNGKey(0)


def _sweep(rng, n):
    pts = np.zeros((n, 18), np.float32)
    pts[:, :3] = rng.uniform(-40, 40, (n, 3))
    pts[:, 3] = rng.randint(0, 7, n)          # dyn_prop
    pts[:, 4] = rng.randint(0, 100, n)        # id
    pts[:, 5] = rng.uniform(-10, 40, n)       # rcs
    pts[:, 6:10] = rng.uniform(-20, 20, (n, 4))
    pts[:, 10:] = rng.randint(0, 5, (n, 8))
    return pts


def _write_ascii(path, pts):
    n = len(pts)
    with open(path, "w") as f:
        f.write(f"VERSION 0.7\nFIELDS {' '.join(RADAR_FIELDS[:10])}\n"
                f"SIZE {' '.join(['4'] * 10)}\nTYPE {' '.join(['F'] * 10)}\n"
                f"COUNT {' '.join(['1'] * 10)}\nWIDTH {n}\nHEIGHT 1\n"
                f"POINTS {n}\nDATA ascii\n")
        for row in pts[:, :10]:
            f.write(" ".join(repr(float(v)) for v in row) + "\n")


@pytest.mark.parametrize("fmt", ["binary", "ascii"])
def test_pcd_reads_as_the_jax_package_reads_it(tmp_path, fmt):
    pts = _sweep(np.random.RandomState(0), 9)
    path = str(tmp_path / f"radar_{fmt}.pcd")
    (write_pcd if fmt == "binary" else _write_ascii)(path, pts)
    got, want = read_radar_pcd(path), jax_read_radar_pcd(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == (9, 18)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 8:10], pts[:, 8:10])


def _radar_info(tmp_path, counts, seed=0):
    """Two radars, rotated and translated sweeps of ``counts`` points each."""
    rng = np.random.RandomState(seed)
    info, k = {}, 0
    for name in ("RADAR_FRONT", "RADAR_BACK_LEFT"):
        sweeps = []
        for _ in range(3):
            path = str(tmp_path / f"r{k}.pcd")
            write_pcd(path, _sweep(rng, counts[k % len(counts)]))
            th = rng.uniform(-np.pi, np.pi)
            rot = np.array([[np.cos(th), -np.sin(th), 0],
                            [np.sin(th), np.cos(th), 0], [0, 0, 1]])
            sweeps.append(dict(data_path=path, sensor2lidar_rotation=rot,
                               sensor2lidar_translation=rng.randn(3),
                               timestamp=0.1 * k))
            k += 1
        info[name] = sweeps
    return info


@pytest.mark.parametrize("case", ["pad", "drop", "empty", "no_compensation"])
def test_multisweep_loading_matches_jax(tmp_path, case):
    counts = {"pad": (7, 0, 11), "drop": (40, 25, 31), "empty": (0,),
              "no_compensation": (9, 4)}[case]
    info = _radar_info(tmp_path, counts)
    kw = dict(sweeps_num=2, max_num=64,
              compensate_velocity=case != "no_compensation")
    outs = []
    for loader in (LoadRadarPointsFromMultiSweeps(**kw), JaxLoadRadar(**kw)):
        res = loader(dict(radar_info=info, timestamp=0.45,
                          rng=np.random.default_rng(3)))
        outs.append((res["radar"], res["radar_mask"], res["rng"].random()))
    (got, got_mask, got_next), (want, want_mask, want_next) = outs
    assert got.shape == (64, 7) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got_mask.all() == (case != "empty") and got_next == want_next


def test_radar_loader_is_registered():
    loader = PIPELINES.build(dict(type="LoadRadarPointsFromMultiSweeps",
                                  sweeps_num=3, max_num=16))
    assert isinstance(loader, LoadRadarPointsFromMultiSweeps)
    assert loader.max_num == 16


@pytest.mark.parametrize("op", ["rotate", "flip_h", "flip_v", "scale"])
def test_radar_points_ops_match_jax(op):
    pts = np.random.RandomState(1).randn(12, 7).astype(np.float32)
    name, arg = {"rotate": ("rotate", 0.7), "flip_h": ("flip", "horizontal"),
                 "flip_v": ("flip", "vertical"), "scale": ("scale", 1.3)}[op]
    got = getattr(RadarPoints(pts), name)(arg)
    want = getattr(JaxRadarPoints(pts), name)(arg)
    np.testing.assert_array_equal(got.tensor, want.tensor)
    assert len(got) == len(want) == 12 and got.vel_dims == (3, 4)


def test_radar_modules_are_registered():
    assert VOXEL_ENCODERS.get("PillarFeatureNet") is PillarFeatureNet
    assert MIDDLE_ENCODERS.get("PointPillarsScatter") is PointPillarsScatter


# a non-square pillar grid: 0.5 m pillars, H = 5 rows of y, W = 7 columns
GRID_RANGE = (-1.5, -1.0, -2.0, 2.0, 1.5, 2.0)
GRID_VOXEL = (0.5, 0.5, 4.0)
H, W = 5, 7


def _pillars(rng, B=2, V=20, F=7):
    """Pillars with unique (b, y, x) cells, a third of them masked (their
    coords -1, as the detector passes them)."""
    cells = np.concatenate([rng.permutation(H * W)[:V] for _ in range(B)])
    coords = np.stack([np.repeat(np.arange(B), V), np.zeros(B * V, int),
                       cells // W, cells % W], 1).astype(np.int32)
    mask = rng.rand(B * V) > 0.3
    coords[~mask] = -1
    feats = rng.randn(B * V, F).astype(np.float32)
    return feats, coords, mask


def test_pillar_feature_net_and_scatter_match_jax():
    rng = np.random.RandomState(0)
    feats, coords, mask = _pillars(rng)
    B, C = 2, 16
    pfn_cfg = dict(in_channels=7, feat_channels=(24, C), voxel_size=GRID_VOXEL,
                   point_cloud_range=GRID_RANGE)
    jpfn, jsc = JaxPFN(**pfn_cfg), JaxScatter(in_channels=C, output_shape=(H, W))
    jargs = (jnp.asarray(feats), jnp.asarray(coords[:, 1:]), jnp.asarray(mask))
    variables = perturb(jpfn.init(KEY, *jargs), scale=0.2)

    def f(x, params):
        p = jpfn.apply({"params": params}, x, *jargs[1:])
        return jsc.apply({}, p, jnp.asarray(coords), jnp.asarray(mask), B)

    want, vjp = jax.vjp(f, jnp.asarray(feats), variables["params"])
    assert want.shape == (B, H, W, C)
    cot = rng.randn(B, H, W, C).astype(np.float32)
    want_dx, want_dp = vjp(jnp.asarray(cot))

    pfn = PillarFeatureNet(**pfn_cfg)
    pfn.load_state_dict(port_state(variables, ("radar_voxel_encoder",),
                                   "radar_voxel_encoder."), strict=True)
    scatter = PointPillarsScatter(in_channels=C, output_shape=(H, W))
    x = t(feats).requires_grad_()
    pillars = pfn(x, t(coords[:, 1:]), t(mask))
    assert bool((pillars[~t(mask)] == 0).all())
    got = scatter(pillars, t(coords), t(mask), B)
    assert got.shape == (B, C, H, W)
    assert got.permute(0, 2, 3, 1).is_contiguous()          # channels_last
    (got * t(cot).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_dx),
                               atol=1e-5, rtol=1e-4)
    assert not x.grad[~t(mask)].any()
    want_p = port_state({"params": want_dp}, ("radar_voxel_encoder",),
                        "radar_voxel_encoder.")
    for n, p in pfn.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_p[n].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=n)


def test_scatter_places_each_pillar_at_its_cell():
    """Each live pillar's row at canvas (b, :, y, x), all else 0."""
    rng = np.random.RandomState(1)
    feats, coords, mask = _pillars(rng, F=3)
    got = PointPillarsScatter(3, (H, W))(t(feats), t(coords), t(mask), 2)
    want = np.zeros((2, 3, H, W), np.float32)
    for v in np.flatnonzero(mask):
        b, _, y, x = coords[v]
        want[b, :, y, x] = feats[v]
    np.testing.assert_array_equal(got.numpy(), want)


RC_KEYS = ("img", "radar", "radar_mask", "lidar2img", "gt_bboxes",
           "gt_labels", "gt_valid")
MODES = {"RC": ("img", "radar", "radar_mask", "lidar2img"),
         "R": ("radar", "radar_mask", "lidar2img"),
         "C": ("img", "lidar2img")}
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def rc_pair():
    """The tiny RC model in both packages: JAX's eval-mode losses and
    gradients (their predictions decoded for RC) and its R and C head
    outputs and boxes (one jit per mode), and the port's model."""
    cfg = tiny_model_cfg(use_radar=True)
    batch = tiny_batch(np.random.RandomState(0), R=64)
    jbatch = {k: batch[k].numpy() for k in RC_KEYS}
    jm = JaxUniBEV(**cfg)
    variables = perturb(jax.jit(functools.partial(jm.init, train=False))(
        dict(params=KEY, gridmask=jax.random.PRNGKey(1)),
        {k: jbatch[k] for k in MODES["RC"]}), scale=0.01)

    def loss_fn(params, b):
        v = {**variables, "params": params}
        preds = jm.apply(v, b, train=False)
        losses = jm.apply(v, b, preds, method=JaxUniBEV.loss)
        return sum(losses.values()), (losses, preds)

    (_, (jlosses, jpreds)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"], jbatch)
    decode = jax.jit(lambda p: jm.apply(variables, p,
                                        method=lambda m, p: m.head.get_bboxes(p)))
    want = {"RC": (jpreds, decode(jpreds))}

    @jax.jit
    def run(v, b):
        preds = jm.apply(v, b, train=False)
        return preds, jm.apply(v, preds, method=lambda m, p: m.head.get_bboxes(p))

    for mode in ("R", "C"):
        want[mode] = run(variables, {k: jbatch[k] for k in MODES[mode]})
    tm = build_model(cfg, "cpu", seed=1, train=True)
    tm.load_state_dict(jax_to_state_dict(variables), strict=True)
    tm.eval()                    # no GridMask, no dropout; gradients stay on
    tbatch = {k: t(v) for k, v in jbatch.items()}
    tlosses = tm.loss(tbatch, tm(tbatch))
    sum(tlosses.values()).backward()
    tgrads = {n: None if p.grad is None else p.grad.clone()
              for n, p in tm.named_parameters()}
    return dict(want=want, tm=tm, tbatch=tbatch, jlosses=jlosses,
                jgrads=jgrads, tlosses={k: v.detach() for k, v in tlosses.items()},
                tgrads=tgrads)


@pytest.mark.parametrize("mode", list(MODES))
def test_rc_model_predict_matches(rc_pair, mode):
    tm = rc_pair["tm"]
    want_preds, want = rc_pair["want"][mode]
    tbatch = {k: rc_pair["tbatch"][k] for k in MODES[mode]}
    with torch.inference_mode():
        preds = tm(tbatch)
    assert (float(preds["l_flag"]), float(preds["c_flag"])) == {
        "RC": (1.0, 1.0), "R": (1.0, 0.0), "C": (0.0, 1.0)}[mode]
    for k in ("all_cls_scores", "all_bbox_preds"):
        np.testing.assert_allclose(preds[k].numpy(), np.asarray(want_preds[k]),
                                   **TOL)
    got = tm.predict(tbatch)
    assert got["bboxes"].shape == (1, 16, 9)
    assert int(got["sca_overflow"]) == 0
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("scores", "bboxes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def test_rc_model_every_loss_term_matches(rc_pair):
    jl, tl = rc_pair["jlosses"], rc_pair["tlosses"]
    assert set(tl) == set(jl) == {"loss_cls", "loss_bbox", "d0.loss_cls",
                                  "d0.loss_bbox"}
    for k in jl:
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=1e-5,
                                   err_msg=k)


def test_rc_model_every_gradient_matches(rc_pair):
    """Every parameter, the pillar feature net's and SECOND's included, within
    1e-3 of its largest gradient."""
    want = jax_to_state_dict({"params": rc_pair["jgrads"]})
    got = rc_pair["tgrads"]
    assert set(got) == {n for n in want if not n.endswith("num_batches_tracked")}
    radar = [n for n in got if n.startswith("radar_voxel_encoder.")]
    assert len(radar) == 3
    for n, w in want.items():
        if n not in got:
            continue
        w = w.numpy()
        g = np.zeros_like(w) if got[n] is None else got[n].numpy()
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * np.abs(w).max(),
                                   err_msg=n)
    for n in radar + ["pts_backbone.blocks.0.0.weight"]:
        assert got[n].abs().max() > 0, n


def test_lidar_with_radar_raises():
    cfg = tiny_model_cfg(use_lidar=True)
    rc = tiny_model_cfg(use_radar=True)
    cfg.update({k: rc[k] for k in ("use_radar", "radar_voxel_layer",
                                   "radar_voxel_encoder",
                                   "radar_middle_encoder")})
    model = build_model(cfg, "cpu", seed=0)
    batch = tiny_batch(np.random.RandomState(0), R=16)
    with pytest.raises(ValueError, match="mutually exclusive"):
        model.predict(batch)
    with pytest.raises(ValueError, match="use_lidar=False"):
        flagship_model_cfg(use_radar=True)


def test_full_width_rc_model_builds_on_meta():
    """180 x 180 pillars of 0.6 m, 40,000 at most, 20 points each; a 64-wide
    pillar net, SECOND on 64 channels, the flagship's camera branch and
    encoders; the synthetic batch's radar cloud: 2048 points over the
    flagship range with the loader's 7 columns."""
    cfg = flagship_model_cfg(use_lidar=False, use_radar=True)
    model = build_model(cfg, "meta")
    assert model.radar_grid == (180, 180, 1)
    assert (model.radar_max_voxels, model.radar_max_points) == (40000, 20)
    assert model.radar_middle_encoder.output_shape == (180, 180)
    assert not hasattr(model, "pts_middle_encoder")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes["radar_voxel_encoder.fc0.weight"] == (64, 9)
    assert shapes["radar_voxel_encoder.ln0.weight"] == (64,)
    assert shapes["pts_backbone.blocks.0.0.weight"] == (128, 64, 3, 3)
    assert shapes["pts_neck.deblocks.1.0.weight"] == (256, 128, 2, 2)
    assert hasattr(model.pts_bbox_head.transformer, "pts_bev_encoder")
    assert ("pts_bbox_head.transformer.pts_bev_encoder.layers.2.ffns.0."
            "layers.1.weight") in shapes
    batch = synthetic_batch(np.random.RandomState(0), N=1, H=32, W=32, P=8,
                            device="cpu", R=RADAR_POINTS)
    radar = batch["radar"].numpy()
    assert radar.shape == (1, 2048, 7) and bool(batch["radar_mask"].all())
    lo, hi = np.array(cfg["radar_voxel_layer"]["point_cloud_range"]).reshape(2, 3)
    assert ((radar[0, :, :3] >= lo) & (radar[0, :, :3] < hi)).all()
    plain = synthetic_batch(np.random.RandomState(0), N=1, H=32, W=32, P=8,
                            device="cpu")
    assert set(batch) - set(plain) == {"radar", "radar_mask"}
    for k in plain:
        assert torch.equal(batch[k], plain[k]), k
