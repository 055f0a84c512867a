"""nuScenes detection metrics, as the devkit computes them, without it.

Counterpart of ``unibev_tpu/data/eval.py``, the port's own copy (held
against it by tests/test_torch_eval.py).  The nuScenes detection score the
reference obtains through ``dataset.evaluate`` and the nuscenes-devkit
(the reference's tools/test_UniBEV.py:235-245), following the devkit's
``detection/algo.py`` formula by formula:

  * per-class accumulation at center-distance thresholds {0.5, 1, 2, 4} m,
    predictions sorted by score over the WHOLE split, greedy min-distance
    matching against unmatched same-class GTs of the same sample;
  * 101-point recall interpolation of precision and confidence; AP = mean of
    (precision - 0.1).clip(0) over recall in (0.1, 1], normalized by 0.9;
  * TP error curves (ATE/ASE/AOE/AVE/AAE) at the 2 m threshold as cumulative
    means over matches, re-sampled onto the recall grid via the confidence
    curve, averaged over recall [0.1, max_achieved_recall];
  * devkit class-range filtering (CVPR-2019 config: 50/40/30 m by class) on
    both predictions and GTs, by xy distance from the ego/lidar origin;
  * per-class exclusions: AOE undefined for traffic_cone (plus AVE/AAE);
    AVE/AAE undefined for barrier; barrier orientation period is pi;
  * scale err = 1 - 3D aligned IoU (intersection of min dims over union);
  * NDS = (5*mAP + sum over the five TP metrics of (1 - min(1, err))) / 10.

Attributes: the reference pipeline gets prediction attributes from
mmdet3d's default-attribute rule (class default, overridden by the
moving/with_rider variant when speed > 0.2 m/s) — ``default_attribute``
below reproduces it.  When GT attributes are absent from the info files the
AAE term is undefined for every class; it is then dropped from NDS numerator
AND denominator (documented deviation — the devkit always has attributes).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0      # devkit dist_th_tp
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_RECALL = 101

# detection_cvpr_2019.json class_range
CLASS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}

TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")
# devkit evaluate.py: metrics not defined for a class are set to nan
CLASS_TP_EXCLUDE = {
    "traffic_cone": ("attr_err", "vel_err", "orient_err"),
    "barrier": ("attr_err", "vel_err"),
}

# mmdet3d NuScenesDataset.DefaultAttribute (the reference's prediction
# attributes — assigned at format_results time, not predicted by the model)
DEFAULT_ATTRIBUTE = {
    "car": "vehicle.parked", "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked", "truck": "vehicle.parked",
    "bus": "vehicle.moving", "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked", "bicycle": "cycle.without_rider",
    "barrier": "", "traffic_cone": "",
}


def default_attribute(class_name: str, velocity_xy: np.ndarray) -> str:
    """mmdet3d's speed-aware default attribute rule (_format_bbox)."""
    if np.linalg.norm(np.asarray(velocity_xy, np.float64)) > 0.2:
        if class_name in ("car", "construction_vehicle", "bus", "truck",
                          "trailer"):
            return "vehicle.moving"
        if class_name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
    else:
        if class_name == "pedestrian":
            return "pedestrian.standing"
        if class_name == "bus":
            return "vehicle.stopped"
    return DEFAULT_ATTRIBUTE.get(class_name, "")


def scale_iou(wlh_a: np.ndarray, wlh_b: np.ndarray) -> float:
    """devkit scale_iou: size-aligned 3D IoU."""
    wlh_a = np.maximum(np.asarray(wlh_a, np.float64), 0)
    wlh_b = np.maximum(np.asarray(wlh_b, np.float64), 0)
    inter = float(np.minimum(wlh_a, wlh_b).prod())
    union = float(wlh_a.prod() + wlh_b.prod() - inter)
    return inter / union if union > 0 else 0.0


def angle_diff(a: float, b: float, period: float) -> float:
    """devkit angle_diff: |(a - b + p/2) mod p - p/2|."""
    d = (a - b + period / 2) % period - period / 2
    return float(abs(d))


def cummean(x: np.ndarray) -> np.ndarray:
    """devkit cummean: nan-aware cumulative mean (all-nan -> ones)."""
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return x.astype(np.float32)
    if np.all(np.isnan(x)):
        return np.ones_like(x, np.float32)
    count = np.cumsum(~np.isnan(x))
    return (np.nancumsum(x) / np.maximum(count, 1)).astype(np.float32)


class MetricData:
    """devkit DetectionMetricData: 101-point curves over the recall grid."""

    def __init__(self, recall, precision, confidence, errs):
        self.recall = recall
        self.precision = precision
        self.confidence = confidence
        self.errs = errs            # dict metric -> (101,) curve

    @property
    def max_recall_ind(self) -> int:
        nz = np.nonzero(self.confidence)[0]
        return int(nz[-1]) if len(nz) else 0

    @classmethod
    def no_predictions(cls):
        grid = np.linspace(0, 1, N_RECALL)
        return cls(grid, np.zeros(N_RECALL), np.zeros(N_RECALL),
                   {k: np.ones(N_RECALL) for k in TP_METRICS})


def accumulate(preds_per_sample: List[Dict], gts_per_sample: List[Dict],
               class_idx: int, class_name: str, dist_th: float) -> Optional[MetricData]:
    """devkit accumulate() for one (class, threshold). Returns None if the
    class has zero GTs (class skipped entirely, devkit evaluate.py)."""
    npos = sum(int((np.asarray(gt["labels"]) == class_idx).sum())
               for gt in gts_per_sample)
    if npos == 0:
        return None

    rows = []   # (score, sample_idx, box, attr)
    for si, pred in enumerate(preds_per_sample):
        pm = np.asarray(pred["labels"]) == class_idx
        boxes = np.asarray(pred["boxes"])[pm]
        scores = np.asarray(pred["scores"])[pm]
        attrs = (np.asarray(pred["attrs"])[pm] if "attrs" in pred
                 else [None] * len(boxes))
        for s, b, a in zip(scores, boxes, attrs):
            rows.append((float(s), si, b, a))
    if not rows:
        return MetricData.no_predictions()
    rows.sort(key=lambda r: -r[0])

    period = np.pi if class_name == "barrier" else 2 * np.pi
    gt_cls = []
    for gt in gts_per_sample:
        gm = np.asarray(gt["labels"]) == class_idx
        gt_cls.append(dict(
            boxes=np.asarray(gt["boxes"])[gm],
            attrs=(np.asarray(gt["attrs"])[gm] if "attrs" in gt else None),
            taken=np.zeros(int(gm.sum()), bool)))

    tp = np.zeros(len(rows))
    fp = np.zeros(len(rows))
    conf = np.array([r[0] for r in rows])
    match = {k: [] for k in TP_METRICS}
    match_conf = []
    for ri, (score, si, box, attr) in enumerate(rows):
        g = gt_cls[si]
        if len(g["boxes"]) == 0:
            fp[ri] = 1
            continue
        d = np.linalg.norm(g["boxes"][:, :2] - box[:2], axis=-1)
        d = np.where(g["taken"], np.inf, d)
        j = int(np.argmin(d))
        if d[j] < dist_th:
            tp[ri] = 1
            g["taken"][j] = True
            gb = g["boxes"][j]
            match["trans_err"].append(float(d[j]))
            match["scale_err"].append(1.0 - scale_iou(box[3:6], gb[3:6]))
            match["orient_err"].append(angle_diff(box[6], gb[6], period))
            match["vel_err"].append(
                float(np.linalg.norm(np.asarray(box[7:9])
                                     - np.asarray(gb[7:9])))
                if len(box) >= 9 and len(gb) >= 9 else np.nan)
            if g["attrs"] is not None and attr is not None \
                    and str(g["attrs"][j]):
                match["attr_err"].append(
                    0.0 if str(attr) == str(g["attrs"][j]) else 1.0)
            else:
                match["attr_err"].append(np.nan)
            match_conf.append(score)
        else:
            fp[ri] = 1

    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    prec = ctp / np.maximum(ctp + cfp, 1e-12)
    rec = ctp / npos
    grid = np.linspace(0, 1, N_RECALL)
    prec_i = np.interp(grid, rec, prec, right=0)
    conf_i = np.interp(grid, rec, conf, right=0)

    errs = {}
    for k in TP_METRICS:
        if len(match_conf) == 0:
            errs[k] = np.ones(N_RECALL)
            continue
        tmp = cummean(np.asarray(match[k], np.float64))
        # resample the per-match curve onto the recall grid via confidence
        # (devkit: interp over reversed/ascending confidence)
        errs[k] = np.interp(conf_i[::-1], np.asarray(match_conf)[::-1],
                            tmp[::-1])[::-1]
    return MetricData(grid, prec_i, conf_i, errs)


def calc_ap(md: MetricData) -> float:
    first = round(100 * MIN_RECALL) + 1
    prec = md.precision.copy()[first:]
    prec = np.maximum(prec - MIN_PRECISION, 0)
    return float(prec.mean() / (1.0 - MIN_PRECISION))


def calc_tp(md: MetricData, metric: str) -> float:
    first = round(100 * MIN_RECALL) + 1
    last = md.max_recall_ind
    if last < first:
        return 1.0
    return float(np.mean(md.errs[metric][first:last + 1]))


def filter_by_range(samples: List[Dict], class_names: Sequence[str],
                    is_gt: bool) -> List[Dict]:
    """devkit filter_eval_boxes: per-class xy-distance range from the EGO
    pose (add_center_dist); GTs with num_pts == 0 are also dropped.

    The devkit measures from the ego pose in the global frame; when a sample
    carries ``l2e_rot``/``l2e_trans`` (lidar->ego), box centers are mapped to
    the ego frame first — equivalent up to the (negligible) pitch/roll of the
    ego pose.  Without them the test falls back to the lidar origin, which
    sits ~0.9 m from the ego origin on nuScenes and can flip boxes right at
    the 30/40/50 m class boundaries."""
    out = []
    for s in samples:
        boxes = np.asarray(s["boxes"], np.float32).reshape(-1, 9) \
            if np.asarray(s["boxes"]).size else np.zeros((0, 9), np.float32)
        labels = np.asarray(s["labels"]).reshape(-1)
        ranges = np.array([CLASS_RANGE.get(
            class_names[int(l)] if 0 <= int(l) < len(class_names) else "",
            50.0) for l in labels], np.float32)
        centers = boxes[:, :3].astype(np.float64)
        if s.get("l2e_rot") is not None:
            centers = centers @ np.asarray(s["l2e_rot"]).T \
                + np.asarray(s["l2e_trans"])
        keep = np.linalg.norm(centers[:, :2], axis=-1) < ranges
        if is_gt and "num_pts" in s and s["num_pts"] is not None:
            keep &= np.asarray(s["num_pts"]).reshape(-1) > 0
        f = dict(boxes=boxes[keep], labels=labels[keep])
        for k in ("scores", "attrs"):
            if k in s and s[k] is not None:
                f[k] = np.asarray(s[k]).reshape(-1)[keep]
        out.append(f)
    return out


def evaluate_detections(preds_per_sample: List[Dict],
                        gts_per_sample: List[Dict],
                        class_names: Sequence[str],
                        apply_range_filter: bool = True) -> Dict[str, float]:
    """preds: dicts of boxes (N,9), scores (N,), labels (N,) [, attrs (N,)];
    gts: dicts of boxes (M,9), labels (M,) [, attrs (M,), num_pts (M,)]."""
    if apply_range_filter:
        preds_per_sample = filter_by_range(preds_per_sample, class_names,
                                           is_gt=False)
        gts_per_sample = filter_by_range(gts_per_sample, class_names,
                                         is_gt=True)

    metrics: Dict[str, float] = {}
    ap_all: List[float] = []
    cls_tp: Dict[str, List[float]] = {k: [] for k in TP_METRICS}
    # deviation (module docstring): without GT attributes anywhere the AAE
    # term is undefined, not "all wrong" (cummean of all-nan would yield 1.0)
    has_attrs = any(g.get("attrs") is not None and len(g["attrs"])
                    for g in gts_per_sample)

    for ci, cname in enumerate(class_names):
        mds = {thr: accumulate(preds_per_sample, gts_per_sample, ci, cname,
                               thr) for thr in DIST_THRESHOLDS}
        if mds[DIST_THRESHOLDS[0]] is None:
            continue
        aps = [calc_ap(mds[thr]) for thr in DIST_THRESHOLDS]
        cls_ap = float(np.mean(aps))
        metrics[f"AP_{cname}"] = cls_ap
        ap_all.append(cls_ap)
        md_tp = mds[TP_THRESHOLD]
        for k in TP_METRICS:
            if k in CLASS_TP_EXCLUDE.get(cname, ()) or (
                    k == "attr_err" and not has_attrs):
                cls_tp[k].append(np.nan)
            else:
                cls_tp[k].append(calc_tp(md_tp, k))

    mAP = float(np.mean(ap_all)) if ap_all else 0.0
    metrics["mAP"] = mAP
    tp_scores = []
    for k in TP_METRICS:
        vals = np.asarray(cls_tp[k], np.float64)
        err = float(np.nanmean(vals)) if vals.size and not np.all(
            np.isnan(vals)) else np.nan
        if np.isnan(err):
            # undefined everywhere (e.g. AAE without GT attributes):
            # drop from NDS numerator AND denominator (deviation, see module
            # docstring), report as nan-sentinel 1.0 kept out of the score
            metrics[f"m{k}"] = float("nan")
            continue
        metrics[f"m{k}"] = err
        tp_scores.append(max(0.0, 1.0 - min(1.0, err)))
    denom = 5.0 + len(tp_scores)
    metrics["NDS"] = float((5 * mAP + sum(tp_scores)) / denom)
    return metrics


def nuscenes_eval(results: List[Dict], dataset) -> Dict[str, float]:
    """Adapter from the test-CLI result dicts + NuScenesDataset annotations.

    Prediction attributes follow mmdet3d's default rule; GT attributes and
    per-box point counts are used when the info files carry them.
    """
    classes = list(dataset.classes)
    preds, gts = [], []
    for i, res in enumerate(results):
        boxes = np.asarray(res["boxes_3d"], np.float32).reshape(-1, 9)
        valid = np.asarray(res.get("valid", [True] * len(boxes)), bool)
        boxes = boxes[valid]
        labels = np.asarray(res["labels_3d"])[valid]
        attrs = np.array([default_attribute(
            classes[int(l)] if 0 <= int(l) < len(classes) else "",
            b[7:9]) for l, b in zip(labels, boxes)], object)
        preds.append(dict(boxes=boxes,
                          scores=np.asarray(res["scores_3d"])[valid],
                          labels=labels, attrs=attrs))
        ann = dataset.get_ann_info(i)
        g = np.asarray(ann["gt_bboxes_3d"], np.float32).reshape(-1, 9)
        gt = dict(boxes=g, labels=np.asarray(ann["gt_labels_3d"]))
        if "gt_attrs" in ann:
            gt["attrs"] = np.asarray(ann["gt_attrs"], object)
        if "num_lidar_pts" in ann:
            gt["num_pts"] = (np.asarray(ann["num_lidar_pts"])
                             + np.asarray(ann.get("num_radar_pts", 0)))
        gts.append(gt)
    return evaluate_detections(preds, gts, classes)
