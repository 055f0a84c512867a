"""The nuScenes metric, JAX package against the port's copy, on seeded
random predictions: every number of ``evaluate_detections`` and
``nuscenes_eval`` within 1e-12 (both are float64 numpy; NaN where the JAX
metric is NaN).
"""

import numpy as np
import pytest

from unibev_tpu.data import eval as jax_eval

from unibev_tpu_torch.data import eval as port_eval

CLASSES = ("car", "truck", "trailer", "bus", "construction_vehicle",
           "bicycle", "motorcycle", "pedestrian", "traffic_cone", "barrier")
ATTRS = ("vehicle.moving", "vehicle.parked", "cycle.with_rider",
         "pedestrian.standing", "")


def _boxes(rng, n, near=None):
    b = np.zeros((n, 9), np.float32)
    if near is None:
        b[:, :2] = rng.uniform(-45, 45, (n, 2))
    else:      # predictions around ground truth: matches at each threshold
        b[:, :2] = near[:, :2] + rng.randn(n, 2) * rng.choice([0.2, 1.0, 3.0],
                                                              (n, 1))
    b[:, 2] = rng.uniform(-2, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[:, 7:9] = rng.randn(n, 2)
    return b


def _samples(seed, n_samples=6, with_attrs=True):
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for _ in range(n_samples):
        m = rng.randint(3, 12)
        g = _boxes(rng, m)
        gl = rng.randint(0, len(CLASSES), m)
        gt = dict(boxes=g, labels=gl, num_pts=rng.randint(0, 30, m))
        if with_attrs:
            gt["attrs"] = np.array([ATTRS[i] for i in rng.randint(0, 5, m)],
                                   object)
        gts.append(gt)
        hit = rng.randint(0, m, rng.randint(1, m))
        p = np.concatenate([_boxes(rng, len(hit), g[hit]), _boxes(rng, 8)])
        pl = np.concatenate([gl[hit], rng.randint(0, 10, 8)])
        pred = dict(boxes=p, scores=rng.rand(len(p)).astype(np.float32),
                    labels=pl)
        if with_attrs:
            pred["attrs"] = np.array([ATTRS[i] for i in
                                      rng.randint(0, 5, len(p))], object)
        preds.append(pred)
    return preds, gts


def _assert_metrics_match(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_attrs", [True, False])
def test_evaluate_detections_matches(seed, with_attrs):
    preds, gts = _samples(seed, with_attrs=with_attrs)
    want = jax_eval.evaluate_detections(preds, gts, CLASSES)
    got = port_eval.evaluate_detections(preds, gts, CLASSES)
    _assert_metrics_match(got, want)
    assert 0 < want["mAP"] < 1


def test_evaluate_detections_without_range_filter_matches():
    preds, gts = _samples(3)
    kw = dict(apply_range_filter=False)
    _assert_metrics_match(
        port_eval.evaluate_detections(preds, gts, CLASSES, **kw),
        jax_eval.evaluate_detections(preds, gts, CLASSES, **kw))


class _Annotated:
    """A dataset's classes and annotations, as nuscenes_eval reads them."""
    classes = CLASSES

    def __init__(self, gts):
        self.gts = gts

    def get_ann_info(self, i):
        g = self.gts[i]
        return dict(gt_bboxes_3d=g["boxes"], gt_labels_3d=g["labels"],
                    gt_attrs=g["attrs"], num_lidar_pts=g["num_pts"])


@pytest.mark.parametrize("seed", [4, 5])
def test_nuscenes_eval_matches(seed):
    preds, gts = _samples(seed)
    rng = np.random.RandomState(seed)
    results = []
    for i, p in enumerate(preds):
        valid = rng.rand(len(p["boxes"])) < 0.9
        results.append(dict(sample_idx=str(i), boxes_3d=p["boxes"].tolist(),
                            scores_3d=p["scores"].tolist(),
                            labels_3d=p["labels"].tolist(),
                            valid=valid.tolist()))
    ds = _Annotated(gts)
    _assert_metrics_match(port_eval.nuscenes_eval(results, ds),
                          jax_eval.nuscenes_eval(results, ds))
